"""B4's wedge culling (tron_tpu_torch.ops.cull.seg_hits) and the culled
plain gridder, the plain version of the CUDA kernel that replaces B4
`_seg_kernel`, on the CPU.

The culled gridder is held to the JAX package's `_seg_kernel` in interpret
mode (as tests/test_grid_pallas.py:46-62 runs it) and to the port's own
planes gridder; the culling is proved conservative against the plain
gridder's own KB terms.  Its segments and items: tests/test_torch_seg_tiles.py.
"""

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
    listed for that tile, for one radius sign or both (integer radii and
    an exact lattice)."""
    rng = np.random.default_rng(seed)
    angles = torch.from_numpy(rng.uniform(0, 2 * np.pi, npe).astype(np.float32))
    beta = kb_beta(kw, 2.0)
    nR = int(rng.integers(16, 2 * nxos)) if exact else None
    if exact:
        rr = lattice_radii(nR, nxos)[1:]
    else:
        rr = (torch.arange(1, nxos) - nxos // 2).to(torch.float32)
    _, nonempty, _ = cull.tile_segments(nxos, kw, nR)
    hits = cull.seg_hits(angles, nxos, kw, nonempty).any(2)
    need = _needed(angles, rr, nxos, cull.TILE, kw, beta)
    assert hits.shape == need.shape
    assert not (need & ~hits).any()


def test_culling_culls_and_lists_are_ordered():
    """At the whole-body geometry a far tile on the rim of the gridded disc
    (its band not empty) keeps a few spokes, each by one sign only, the
    centre tiles keep all for both signs, and each tile's list holds its
    segments in ascending spoke order, a spoke's negative-radius segment
    first."""
    angles = torch.from_numpy(np.asarray(jangles(204, "golden", 19000)))
    starts, nonempty, seg = cull.tile_segments(512, KW)
    hits = cull.seg_hits(angles, 512, KW, nonempty)
    assert hits.shape == (32, 32, 2, 204)
    counts = hits.any(2).sum(-1)
    assert int(hits[15, 15].sum()) == 408
    for t in [(4, 4), (1, 15), (15, 0)]:
        assert nonempty[t].all()
        assert 0 < int(counts[t]) < 20 and int(hits[t].sum()) == int(counts[t])
    assert float(counts.float().mean()) < 0.2 * 204
    entries = cull.seg_entries(hits, starts)
    for i, j in [(1, 1), (3, 17), (15, 16), (31, 2)]:
        ent = entries[i * 32 + j]
        assert len(ent) == int(hits[i, j].sum())
        keys = [(p, 0 if u == starts[i, j, 1] and hits[i, j, 1, p] else 1) for p, u in ent]
        assert keys == sorted(keys) and len(set(keys)) == len(keys)
