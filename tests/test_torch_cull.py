"""Per-tile spoke culling (tron_tpu_torch.ops.cull) and the tile-culled
plain gridder, the plain version of the CUDA kernel that replaces B4
`_seg_kernel`, on the CPU.

The culled gridder is held to the JAX package's `_seg_kernel` in interpret
mode (as tests/test_grid_pallas.py:46-62 runs it) and to the port's own
planes gridder; the culling test is proved conservative against the plain
gridder's own KB terms.  The bound on the rows of one (pixel, spoke) band,
which sizes the static-unroll kernel (B5), is checked by brute force.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.conftest import nrmse
from tron_tpu.config import AngleScheme as JAngleScheme
from tron_tpu.ops import grid_pallas as jgrid_pallas
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch.kernels.kb import kb_beta, kb_kernel
from tron_tpu_torch.ops import cull, grid, grid_cuda
from tron_tpu_torch.ops.degrid import lattice_radii

torch.set_num_threads(1)

KW = 2.0
BETA = kb_beta(KW, 2.0)


def _data(seed, C, npe, nro) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((C, npe, nro)) + 1j * rng.standard_normal((C, npe, nro))
    d = d.astype(np.complex64)
    d[:, : npe // 2] *= -1  # signed, as an incremental delta
    return d


@pytest.mark.parametrize(
    "C,npe,nxos,scheme,skip",
    [(2, 12, 256, JAngleScheme.GOLDEN, 20055), (2, 7, 384, JAngleScheme.GOLDEN, 3),
     (2, 16, 256, JAngleScheme.LINEAR_HALF, 0)],
)
def test_culled_plain_matches_jax_seg_kernel(C, npe, nxos, scheme, skip):
    """The port's plain culled gridder vs `_seg_kernel` (windowed=False,
    float32) in interpret mode: the same fp32 terms in another order,
    tests/test_grid_pallas.py:53."""
    d = _data(nxos + npe, C, npe, nxos)
    ang = np.asarray(jangles(npe, scheme, skip))
    want = np.asarray(
        jgrid_pallas.grid_radial2d_pallas(
            jnp.asarray(d), jnp.asarray(ang), nxos, KW, BETA, pe_chunk=4, tile=128,
            matmul_dtype="float32", interpret=True, windowed=False,
        )
    )
    launches = grid_cuda.LAUNCHES
    got = grid_cuda.grid_radial2d(
        torch.from_numpy(d), torch.from_numpy(ang), nxos, KW, BETA, windowed=False
    )
    assert grid_cuda.LAUNCHES == launches  # a CPU tensor never reaches a kernel
    assert got.shape == (C, nxos, nxos) and got.dtype == torch.complex64
    assert nrmse(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize(
    "nxos,C,npe,exact,kw",
    [(64, 1, 8, False, 2.0), (100, 3, 9, False, 2.0), (128, 2, 30, True, 2.0),
     (96, 2, 12, False, 1.5), (80, 1, 10, True, 3.0)],
)
def test_culled_plain_equals_planes_plain(nxos, C, npe, exact, kw):
    """Culling drops only zero terms: the culled gridder equals the planes
    gridder to fp32 summation order (1e-6), partial edge tiles (100, 80)
    and the exact lattice included."""
    beta = kb_beta(kw, 2.0)
    rng = np.random.default_rng(nxos + C)
    nR = nxos * 3 // 4 if exact else nxos
    planes = torch.from_numpy(rng.standard_normal((npe, nR, 2 * C), dtype=np.float32))
    ang = torch.from_numpy(np.asarray(jangles(npe, "golden", 19000 + nxos)))
    if exact:
        rad = lattice_radii(nR, nxos)
        got = grid.grid_radial2d_planes_culled(planes, ang, nxos, kw, beta, rad=rad)
        # the dense raw-rows form of the same sum (row 0 dropped)
        want = grid.grid_radial2d(
            torch.view_as_complex(planes.reshape(npe, nR, C, 2).permute(2, 0, 1, 3).contiguous())
            .index_fill(-1, torch.tensor([0]), 0),
            ang, nxos, kw, beta, raw_rows=True,
        )
    else:
        got = grid.grid_radial2d_planes_culled(planes, ang, nxos, kw, beta)
        want = grid.grid_radial2d_planes_plain(planes, ang, nxos, kw, beta)
    assert nrmse(got.numpy(), want.numpy()) <= 1e-6


def test_exact_entry_windowed_false():
    d = torch.from_numpy(_data(4, 2, 9, 96))
    ang = torch.from_numpy(np.asarray(jangles(9, "golden", 5)))
    culled = grid_cuda.grid_radial2d_exact(d, ang, 128, KW, BETA, windowed=False)
    dense = grid_cuda.grid_radial2d_exact(d, ang, 128, KW, BETA)
    assert nrmse(culled.numpy(), dense.numpy()) <= 1e-6


def _needed(angles, rr, nxos, tile, kw, beta):
    """(tiles_y, tiles_x, npe): spoke p gives some pixel of tile (i, j) a
    nonzero term, from the plain gridder's own products and KB
    (ops/grid.py:_grid_dense)."""
    X = (torch.arange(nxos) - nxos // 2).to(torch.float32)
    ct, st = torch.cos(angles), torch.sin(angles)
    ax = kb_kernel(rr[None, :, None] * ct[:, None, None] - X, kw, beta) != 0  # (P, nR, nx)
    ay = kb_kernel(rr[None, :, None] * st[:, None, None] - X, kw, beta) != 0
    ntile = -(-nxos // tile)
    pad = ntile * tile - nxos

    def per_tile(a):
        a = torch.nn.functional.pad(a, (0, pad))
        return a.reshape(a.shape[0], a.shape[1], ntile, tile).any(-1).float()

    need = torch.einsum("pry,prx->yxp", per_tile(ay), per_tile(ax)) > 0
    return need


@settings(max_examples=40, deadline=None, database=None)
@given(
    nxos=st.integers(24, 120),
    npe=st.integers(1, 12),
    kw=st.sampled_from([1.5, 2.0, 3.0]),
    exact=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_culling_is_conservative(nxos, npe, kw, exact, seed):
    """Every spoke that gives any nonzero KB term to any pixel of a tile is
    in that tile's hit list (integer radii and an exact lattice)."""
    rng = np.random.default_rng(seed)
    angles = torch.from_numpy(rng.uniform(0, 2 * np.pi, npe).astype(np.float32))
    beta = kb_beta(kw, 2.0)
    if exact:
        rr = lattice_radii(int(rng.integers(8, 2 * nxos)), nxos)[1:]
    else:
        rr = (torch.arange(1, nxos) - nxos // 2).to(torch.float32)
    hits = cull.tile_hits(angles, nxos, kw)
    need = _needed(angles, rr, nxos, cull.TILE, kw, beta)
    assert hits.shape == need.shape
    assert not (need & ~hits).any()


def test_culling_culls_and_lists_are_ordered():
    """At the whole-body geometry a far tile keeps a few spokes, the centre
    tiles keep all, and each list holds its hits in ascending order."""
    angles = torch.from_numpy(np.asarray(jangles(204, "golden", 19000)))
    hits = cull.tile_hits(angles, 512, KW)
    counts, lists = cull.hit_lists(hits)
    assert counts.shape == (32, 32) and lists.shape == (32, 32, 204)
    assert int(counts[15, 15]) == 204 and int(counts[0, 0]) < 20
    assert float(counts.float().mean()) < 0.2 * 204
    for i, j in [(0, 0), (3, 17), (15, 16), (31, 2)]:
        n = int(counts[i, j])
        lst = lists[i, j, :n]
        assert torch.equal(lst, torch.nonzero(hits[i, j]).flatten())
    cy, cx, d = cull.tile_geometry(100)
    assert cy.shape == (7, 7) and float(d[-1, -1]) == pytest.approx(math.hypot(1.5, 1.5))


def _band_rows(X, Y, c, s, kw, nxos, rows_per_unit, exact):
    """The kernel's widened row band (csrc/grid_radial2d.cuh:span_band at one pixel) in
    float32, vectorised over pixels and spokes: its row count."""
    f = np.float32
    kw = f(kw)
    h = nxos // 2
    with np.errstate(divide="ignore", invalid="ignore"):
        ic = np.where(c != 0, f(1) / c, f(0)).astype(f)
        is_ = np.where(s != 0, f(1) / s, f(0)).astype(f)
    if exact:
        lo = np.full(np.broadcast(X, c).shape, -f(nxos), f)
        hi = np.full_like(lo, f(nxos))
    else:
        lo = np.full(np.broadcast(X, c).shape, f(1 - h), f)
        hi = np.full_like(lo, f(nxos - 1 - h))
    for p, inv in ((X, ic), (Y, is_)):
        a = ((p - kw) * inv).astype(f)
        b = ((p + kw) * inv).astype(f)
        m = inv != 0
        lo = np.where(m, np.maximum(lo, np.minimum(a, b)), lo)
        hi = np.where(m, np.minimum(hi, np.maximum(a, b)), hi)
    if exact:
        nR = int(round(nxos * rows_per_unit))
        u0 = np.maximum(np.floor(lo * f(rows_per_unit) + f(nR / 2)) - 1, 1)
        u1 = np.minimum(np.ceil(hi * f(rows_per_unit) + f(nR / 2)) + 1, nR - 1)
    else:
        u0 = np.maximum(np.floor(lo) - 1, 1 - h)
        u1 = np.minimum(np.ceil(hi) + 1, nxos - 1 - h)
    return np.where(u0 <= u1, u1 - u0 + 1, 0)


@pytest.mark.parametrize(
    "kw,nxos,nR",
    [(1.5, 256, 256), (2.0, 256, 256), (3.0, 256, 256), (2.0, 192, 256), (3.0, 192, 256),
     (2.0, 320, 256)],
)
def test_row_bound_covers_the_longest_band(kw, nxos, nR):
    """``row_bound`` vs the brute-force longest band of the kernel's own
    fp32 band arithmetic over every pixel and 600 spokes (integer radii
    and the exact lattice at gridos 1.5, 2 and 2.5); the bound is tight to
    within two rows."""
    exact = nR != nxos
    rpu = nR / nxos
    rng = np.random.default_rng(int(10 * kw) + nxos)
    ang = np.concatenate([rng.uniform(0, 2 * np.pi, 590), np.arange(10) * np.pi / 4])
    c = np.cos(ang.astype(np.float32)).astype(np.float32)
    s = np.sin(ang.astype(np.float32)).astype(np.float32)
    coord = (np.arange(nxos) - nxos // 2).astype(np.float32)
    longest = 0
    for y in coord[:: max(1, nxos // 64)]:
        rows = _band_rows(coord[:, None], np.float32(y), c[None, :], s[None, :], kw, nxos, rpu, exact)
        longest = max(longest, int(rows.max()))
    bound = grid_cuda.row_bound(kw, rpu)
    assert longest <= bound <= longest + 2
    assert grid_cuda.pick_nslot(kw, rpu) >= bound


def test_pick_nslot_raises_beyond_the_built_slots():
    assert grid_cuda.pick_nslot(2.0) == 10
    assert grid_cuda.pick_nslot(2.0, 512 / 384) == 12
    assert grid_cuda.pick_nslot(3.0) == 16
    with pytest.raises(ValueError, match="row slots"):
        grid_cuda.pick_nslot(5.0)
