"""The decomposition of the port's segmented gridding kernel
(`tron_tpu_torch/csrc/grid_seg_radial2d.cu`, which replaces B4
`_seg_kernel`), on the CPU.

The kernel runs only on the card; its decomposition is held here through
its torch twins (`ops/cull.py`): the static per-(tile, sign) segments
(``tile_segments``, the port of JAX's `_tile_segments`), the wedge culling
(``seg_hits``, against JAX's `_culling_tables` with cull="geom"), the
listed segments in the kernel's order (``seg_entries``) and its items
(``item_ranges`` at ``seg_item_rows``); and through a torch model of its
contraction (below, used only by these tests): per tile, per item of whole
segments, the items' sums added in order.  Both are proved conservative
against the plain gridder's own KB terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.conftest import nrmse
from tron_tpu.ops import grid_pallas as jgrid_pallas
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch.kernels.kb import kb_beta, kb_kernel
from tron_tpu_torch.ops import cull, grid
from tron_tpu_torch.ops.degrid import lattice_radii

torch.set_num_threads(1)

# (nxos, nR of an exact lattice or None): integer radii, and the natural
# lattices of gridos 1.5 (nxos = 3/4 nro) and 2.5 (nxos = 5/4 nro)
GEOMETRIES = [(64, None), (128, None), (256, None), (512, None),
              (96, 128), (192, 256), (384, 512), (80, 64), (160, 128), (320, 256)]


@pytest.mark.parametrize("kw", [1.5, 2.0, 3.0])
@pytest.mark.parametrize("nxos,nR", GEOMETRIES)
def test_segments_equal_jax(nxos, nR, kw):
    """The port's segments are JAX's `_tile_segments(nxos, 16, kw, nR=...,
    row_scale=...)`, integer for integer: starts, nonempty flags and the
    segment length."""
    if nR is None:
        want = jgrid_pallas._tile_segments(nxos, 16, kw)
    else:
        want = jgrid_pallas._tile_segments(nxos, 16, kw, nR=nR, row_scale=nxos / nR)
    starts, nonempty, seg = cull.tile_segments(nxos, kw, nR)
    np.testing.assert_array_equal(starts, want[0])
    np.testing.assert_array_equal(nonempty, want[1])
    assert seg == want[2]


def _jax_hits(angles, nxos, kw):
    """JAX's per-(tile, sign) hits (`_culling_tables`, cull="geom", one chunk
    of all spokes) as (tiles, tiles, 2, npe) bool."""
    _, nonempty, _, _ = jgrid_pallas._tile_segments(nxos, 16, kw)
    npe = angles.shape[0]
    counts, lists = jgrid_pallas._culling_tables(
        jnp.asarray(angles), nxos, 16, kw, nonempty, 1, npe, "geom")
    n = nxos // 16
    counts = np.asarray(counts).reshape(n * n, 2)
    lists = np.asarray(lists).reshape(n * n, 2, npe)
    hits = np.zeros((n * n, 2, npe), bool)
    for t in range(n * n):
        for s in range(2):
            hits[t, s, lists[t, s, : counts[t, s]]] = True
    return hits.reshape(n, n, 2, npe), nonempty


@pytest.mark.parametrize(
    "nxos,npe,scheme,kw",
    [(512, 204, "golden", 2.0), (256, 48, "golden", 3.0), (128, 30, "linear_half", 1.5),
     (384, 64, "linear_half", 2.0)],
)
def test_seg_hits_contain_jax_culling(nxos, npe, scheme, kw):
    """Every (tile, sign, spoke) that JAX's angular wedge keeps is listed;
    the port's Cartesian test with its fp32 slacks lists at most 2 % more."""
    angles = np.asarray(jangles(npe, scheme, 19000 if scheme == "golden" else 0))
    want, nonempty = _jax_hits(angles, nxos, kw)
    got = cull.seg_hits(torch.from_numpy(angles), nxos, kw, nonempty).numpy()
    assert got.shape == want.shape
    assert not (want & ~got).any()
    assert got.sum() <= 1.02 * want.sum() + 4


def _needed(angles, rr, nxos, kw, beta, tile=cull.TILE):
    """(tiles_y, tiles_x, npe, nR) bool: row u of spoke p gives some pixel of
    the tile a nonzero term of the plain gridder (its own products and KB,
    ops/grid.py:_grid_dense); row 0 is never gridded."""
    X = (torch.arange(nxos) - nxos // 2).to(torch.float32)
    ct, st_ = torch.cos(angles), torch.sin(angles)
    ax = kb_kernel(rr[None, :, None] * ct[:, None, None] - X, kw, beta) != 0  # (P, nR, nx)
    ay = kb_kernel(rr[None, :, None] * st_[:, None, None] - X, kw, beta) != 0
    ntile = -(-nxos // tile)
    pad = ntile * tile - nxos

    def per_tile(a):
        a = torch.nn.functional.pad(a, (0, pad))
        return a.reshape(a.shape[0], a.shape[1], ntile, tile).any(-1)  # (P, nR, ntile)

    need = per_tile(ay).permute(2, 0, 1)[:, None] & per_tile(ax).permute(2, 0, 1)[None]
    need[..., 0] = False
    return need


def _listed(angles, nxos, kw, nR, exact):
    """(tiles_y, tiles_x, npe, nR) bool: row u of spoke p lies in one of the
    tile's listed segments; and the count of rows listed twice."""
    starts, nonempty, seg = cull.tile_segments(nxos, kw, nR if exact else None)
    hits = cull.seg_hits(angles, nxos, kw, nonempty)                  # (ty, tx, 2, P)
    u = torch.arange(nR)
    s0 = torch.as_tensor(starts).long()[..., None, None]              # (ty, tx, 2, 1, 1)
    inseg = (u >= s0) & (u < s0 + seg) & hits[..., None]              # (ty, tx, 2, P, nR)
    return inseg.any(2), inseg.all(2)


@settings(max_examples=40, deadline=None, database=None)
@given(
    nxos=st.integers(24, 120),
    npe=st.integers(1, 12),
    kw=st.sampled_from([1.5, 2.0, 3.0]),
    exact=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_seg_lists_are_conservative(nxos, npe, kw, exact, seed):
    """Every nonzero term of the plain gridder lies in a listed segment of
    its tile (integer radii, partial edge tiles, exact lattices of any row
    count, odd ones included), and no row lies in both of a tile's listed
    segments for one spoke where it has a term."""
    rng = np.random.default_rng(seed)
    angles = torch.from_numpy(rng.uniform(0, 2 * np.pi, npe).astype(np.float32))
    nR = int(rng.integers(16, 2 * nxos)) if exact else nxos
    rr = lattice_radii(nR, nxos) if exact else (torch.arange(nxos) - nxos // 2).to(torch.float32)
    need = _needed(angles, rr, nxos, kw, kb_beta(kw, 2.0))
    listed, twice = _listed(angles, nxos, kw, nR, exact)
    assert not (need & ~listed).any()
    assert not (need & twice).any()


def _entries(angles, nxos, kw, nR=None):
    starts, nonempty, seg = cull.tile_segments(nxos, kw, nR)
    return cull.seg_entries(cull.seg_hits(angles, nxos, kw, nonempty), starts), seg


@pytest.mark.parametrize("granule", [1, 2, 8])
@pytest.mark.parametrize("nxos,npe,nR", [(100, 9, None), (256, 40, 320)])
def test_seg_items_cover_rows_once_in_order(nxos, npe, nR, granule):
    """Each tile's rows are its listed segments end to end; the items (L =
    whole segments, here ``granule`` times the least) are consecutive
    ranges of whole segments, from the first row to the last, and a row's
    (spoke, row) follows from its index by integer division: spokes
    ascending, and within a spoke the rows ascending (the negative-radius
    segment first)."""
    angles = torch.from_numpy(np.asarray(jangles(npe, "golden", 5)))
    entries, seg = _entries(angles, nxos, 2.0, nR)
    L = granule * cull.seg_item_rows(seg)
    assert L % seg == 0 and L >= cull.ITEM_ROWS
    items = cull.item_ranges([len(e) * seg for e in entries], L)
    for ent, its in zip(entries, items):
        n = len(ent) * seg
        assert its[0][0] == 0 and its[-1][1] == n
        for (a, b), (c, _) in zip(its, its[1:]):
            assert b == c
        assert all(a % seg == 0 and b % seg == 0 for a, b in its)
        rows = [(ent[q // seg][0], ent[q // seg][1] + q % seg) for a, b in its for q in range(a, b)]
        assert len(rows) == n
        spokes = [p for p, _ in rows]
        assert spokes == sorted(spokes)
        for p in set(spokes):
            r = [u for q, u in rows if q == p]
            assert r == sorted(r)


def seg_tiled_grid(planes, angles, nxos, kw, beta, rad=None, item_segments=8):
    """A torch model of B4's contraction: per tile, its listed segments' rows
    (row 0 dropped) at its 16 columns and rows, summed item by item (items
    of ``item_segments`` whole segments), the items' sums added in order;
    (C, nxos, nxos) complex64 scaled by 1/(nxos*npe)."""
    npe, nR, K = planes.shape
    exact = rad is not None
    rr = rad if exact else (torch.arange(nR) - nxos // 2).to(torch.float32)
    entries, seg = _entries(angles, nxos, kw, nR if exact else None)
    ct, st_ = torch.cos(angles), torch.sin(angles)
    n = -(-nxos // cull.TILE)
    coord = (torch.arange(n * cull.TILE) - nxos // 2).to(torch.float32)
    out = planes.new_zeros((K, n * cull.TILE, n * cull.TILE))
    for t, ent in enumerate(entries):
        i, j = divmod(t, n)
        ys = slice(i * cull.TILE, (i + 1) * cull.TILE)
        xs = slice(j * cull.TILE, (j + 1) * cull.TILE)
        acc = planes.new_zeros((K, cull.TILE, cull.TILE))
        for e0 in range(0, len(ent), item_segments):
            spoke = torch.tensor([p for p, _ in ent[e0:e0 + item_segments] for _ in range(seg)],
                                 dtype=torch.long)
            row = torch.tensor([u + k for _, u in ent[e0:e0 + item_segments] for k in range(seg)],
                               dtype=torch.long)
            r = rr[row]
            wx = kb_kernel(r[:, None] * ct[spoke, None] - coord[xs], kw, beta) * (row != 0)[:, None]
            wy = kb_kernel(r[:, None] * st_[spoke, None] - coord[ys], kw, beta)
            acc = acc + torch.einsum("ry,rx,rk->kyx", wy, wx, planes[spoke, row])
        out[:, ys, xs] = acc
    out = out[:, :nxos, :nxos] * (1.0 / (nxos * npe))
    return torch.view_as_complex(out.reshape(K // 2, 2, nxos, nxos).permute(0, 2, 3, 1).contiguous())


@pytest.mark.parametrize(
    "nxos,C,npe,nR,kw,item_segments",
    [(64, 1, 8, None, 2.0, 8), (100, 3, 17, None, 2.0, 3), (128, 2, 30, 96, 2.0, 2),
     (96, 2, 12, None, 1.5, 1), (80, 1, 10, 64, 3.0, 4), (96, 2, 11, 128, 2.0, 5)],
)
def test_seg_model_matches_plain(nxos, C, npe, nR, kw, item_segments):
    """The model of B4's items and the port's culled plain gridder (B4's
    plain version) equal the planes gridder to fp32 grouping (1e-6):
    partial edge tiles (100, 80), exact lattices (gridos 2.5, 1.5 and 8/3),
    split tiles (short items)."""
    beta = kb_beta(kw, 2.0)
    rng = np.random.default_rng(nxos + npe)
    rows = nR or nxos
    planes = torch.from_numpy(rng.standard_normal((npe, rows, 2 * C), dtype=np.float32))
    planes[: npe // 2] *= -1
    angles = torch.from_numpy(np.asarray(jangles(npe, "golden", 19000 + nxos)))
    rad = lattice_radii(rows, nxos) if nR else None
    got = seg_tiled_grid(planes, angles, nxos, kw, beta, rad=rad, item_segments=item_segments)
    culled = grid.grid_radial2d_planes_culled(planes, angles, nxos, kw, beta, rad=rad)
    if nR:
        d = torch.view_as_complex(planes.reshape(npe, rows, C, 2).permute(2, 0, 1, 3).contiguous())
        want = grid.grid_radial2d(grid.drop_readout0(d), angles, nxos, kw, beta, raw_rows=True)
    else:
        want = grid.grid_radial2d_planes_plain(planes, angles, nxos, kw, beta)
    assert nrmse(got.numpy(), want.numpy()) <= 1e-6
    assert nrmse(culled.numpy(), want.numpy()) <= 1e-6


def test_whole_body_segments():
    """At the whole-body geometry (nxos 512, 204 golden spokes, kw 2): 32-row
    segments, the 13,816 (tile, sign, spoke) triples JAX keeps (listed, and
    at most 1 % more), so ~2.3x the rows of B1's tile bands; the centre
    tiles list every spoke for both signs, 408 segments, and the slots cover
    2 R / L."""
    angles = np.asarray(jangles(204, "golden", 19000))
    starts, nonempty, seg = cull.tile_segments(512, 2.0)
    hits = cull.seg_hits(torch.from_numpy(angles), 512, 2.0, nonempty)
    jax_hits, _ = _jax_hits(angles, 512, 2.0)
    assert seg == 32 and int(jax_hits.sum()) == 13816
    assert 13816 <= int(hits.sum()) <= 1.01 * 13816
    assert int(hits[15, 15].sum()) == 408
    first, last = cull.tile_bands(torch.from_numpy(angles), 512, 2.0)
    b1_rows = int(torch.clamp(last - first + 1, min=0).sum())
    assert 2.2 < int(hits.sum()) * seg / b1_rows < 2.5
    L = cull.seg_item_rows(seg)
    assert L == 256
    assert 2 * int(hits.sum()) * seg / L <= cull.seg_slots(204, 512, 2.0)
