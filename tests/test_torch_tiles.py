"""The tile decomposition of the port's default gridding kernel
(`tron_tpu_torch/csrc/grid_radial2d.cu`, which replaces B1 `_win_kernel` and
B2 `_grid_kernel`) and of its tensor-core variant
(`csrc/grid_radial2d_batched.cu`, which replaces B5 `_win_kernel_batched`),
on the CPU.

The kernels run only on the card; their decomposition is held here through
torch twins of their first two passes (`ops/cull.tile_bands`, pass 1's tile
bands, and `ops/cull.work_items`, pass 2's items) and torch models of their
contractions (below, used only by these tests): per tile, per item, the
items' sums added in order; for B5 each item's rows in static 8-row
k-steps of split TF32 products (3xTF32, TF32 emulated by rounding to 10
mantissa bits).  The twin is proved conservative against the plain
gridder's own KB terms, the items against the rows they cut, and the models
against the plain gridder and JAX's `grid_radial2d_pallas` in interpret
mode (as tests/test_grid_pallas.py runs it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.conftest import nrmse
from tron_tpu.config import AngleScheme as JAngleScheme
from tron_tpu.config import KernelTuning as JKernelTuning
from tron_tpu.ops import grid_pallas as jgrid_pallas
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch.config import KernelTuning
from tron_tpu_torch.kernels.kb import kb_beta, kb_kernel
from tron_tpu_torch.ops import cull, grid, grid_cuda
from tron_tpu_torch.ops.degrid import lattice_radii

torch.set_num_threads(1)

TOL = 1e-5  # NRMSE: the same fp32 terms summed in another grouping


def _radii(nxos, nR, exact):
    """The row radii of the sample planes: integer radii or the lattice."""
    if exact:
        return lattice_radii(nR, nxos)
    return (torch.arange(nxos) - nxos // 2).to(torch.float32)


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


def _check_conservative(angles, nxos, nR, kw, exact):
    beta = kb_beta(kw, 2.0)
    first, last = cull.tile_bands(angles, nxos, kw, nR if exact else None)
    need = _needed(angles, _radii(nxos, nR, exact), nxos, kw, beta)
    u = torch.arange(need.shape[-1])
    inside = (u >= first[..., None]) & (u <= last[..., None])
    assert first.shape == need.shape[:3]
    assert not (need & ~inside).any()
    assert int(first.min()) >= 1  # row 0 is never in a band
    return inside, need


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("kw", [1.5, 2.0, 3.0])
@pytest.mark.parametrize("scheme", ["golden", "linear_half"])
@pytest.mark.parametrize("nxos", [64, 100, 128, 256])
def test_tile_bands_are_conservative(nxos, scheme, kw, exact):
    """Every nonzero term of the plain gridder lies in its tile's (spoke,
    row range), partial edge tiles (nxos 100) and an exact lattice (3/4 of
    nxos rows) included; the bands list few rows beyond the needed ones."""
    npe = 12
    angles = torch.from_numpy(np.asarray(jangles(npe, scheme, 19000 if scheme == "golden" else 0)))
    nR = nxos * 3 // 4 if exact else nxos
    inside, need = _check_conservative(angles, nxos, nR, kw, exact)
    assert int(inside.sum()) <= 3 * int(need.sum()) + 8 * inside[..., 0].numel()


@settings(max_examples=30, deadline=None, database=None)
@given(
    nxos=st.integers(24, 160),
    npe=st.integers(1, 10),
    kw=st.sampled_from([1.5, 2.0, 3.0]),
    exact=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_tile_bands_conservative_random(nxos, npe, kw, exact, seed):
    """The same at random angles, grid sizes and lattice rows."""
    rng = np.random.default_rng(seed)
    angles = torch.from_numpy(rng.uniform(0, 2 * np.pi, npe).astype(np.float32))
    nR = int(rng.integers(8, 2 * nxos)) if exact else nxos
    _check_conservative(angles, nxos, nR, kw, exact)


def _rows(first, last, i, j):
    """Tile (i, j)'s listed rows in pass 1's order: spokes ascending, each
    band's rows ascending.  Returns (spoke, row) index tensors."""
    f, lst = first[i, j], last[i, j]
    n = torch.clamp(lst - f + 1, min=0)
    spoke = torch.repeat_interleave(torch.arange(f.shape[0]), n)
    start = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    row = torch.repeat_interleave(f, n) + torch.arange(int(n.sum())) - start
    return spoke, row


@pytest.mark.parametrize("L", [1, 7, 64, 256])
@pytest.mark.parametrize("nxos,npe", [(100, 9), (256, 40)])
def test_work_items_cover_rows_once_in_order(nxos, npe, L):
    """Each tile's items are consecutive ranges over its listed rows, from
    the first to the last, at most L rows each; a tile without rows has one
    empty item, which writes its zeros."""
    angles = torch.from_numpy(np.asarray(jangles(npe, "golden", 5)))
    first, last = cull.tile_bands(angles, nxos, 2.0)
    items = cull.work_items(first, last, L)
    rows = torch.clamp(last - first + 1, min=0).sum(-1).flatten().tolist()
    assert len(items) == len(rows) == first.shape[0] * first.shape[1]
    for its, n in zip(items, rows):
        assert its[0][0] == 0 and its[-1][1] == n
        for (a, b), (c, _) in zip(its, its[1:]):
            assert b == c
        assert all(0 < b - a <= L for a, b in its) or its == [(0, 0)]
        assert len(its) == max(1, -(-n // L))
    # the listed rows are spokes ascending, rows ascending within a spoke
    spoke, row = _rows(first, last, first.shape[0] // 2, first.shape[1] // 2)
    key = spoke * 10**6 + row
    assert torch.equal(key, torch.sort(key).values) and len(set(key.tolist())) == len(key)


def tiled_grid(planes, angles, nxos, kw, beta, rad=None, item_rows=256):
    """A torch model of the tile kernel's contraction: per tile, its listed
    rows' separable weights at its 16 columns and rows, summed item by item,
    the items' sums added in order; (C, nxos, nxos) complex64 scaled by
    1/(nxos*npe).  ``rad`` None grids integer radii, else the lattice."""
    npe, nR, K = planes.shape
    exact = rad is not None
    rr = rad if exact else _radii(nxos, nR, False)
    first, last = cull.tile_bands(angles, nxos, kw, nR if exact else None)
    items = cull.work_items(first, last, item_rows)
    ct, st_ = torch.cos(angles), torch.sin(angles)
    coord = (torch.arange(nxos) - nxos // 2).to(torch.float32)
    out = planes.new_zeros((K, nxos, nxos))
    ntx = first.shape[1]
    for t, its in enumerate(items):
        i, j = divmod(t, ntx)
        ys, xs = slice(i * cull.TILE, (i + 1) * cull.TILE), slice(j * cull.TILE, (j + 1) * cull.TILE)
        spoke, row = _rows(first, last, i, j)
        r = rr[row]
        wx = kb_kernel(r[:, None] * ct[spoke, None] - coord[xs], kw, beta)  # (rows, nx)
        wy = kb_kernel(r[:, None] * st_[spoke, None] - coord[ys], kw, beta)  # (rows, ny)
        s = planes[spoke, row]                                              # (rows, K)
        acc = planes.new_zeros((K, wy.shape[1], wx.shape[1]))
        for a, b in its:
            acc = acc + torch.einsum("ry,rx,rk->kyx", wy[a:b], wx[a:b], s[a:b])
        out[:, ys, xs] = acc
    out = out * (1.0 / (nxos * npe))
    return torch.view_as_complex(out.reshape(K // 2, 2, nxos, nxos).permute(0, 2, 3, 1).contiguous())


@pytest.mark.parametrize(
    "nxos,C,npe,exact,kw,item_rows",
    [(64, 1, 8, False, 2.0, 256), (100, 3, 17, False, 2.0, 40), (128, 2, 30, True, 2.0, 64),
     (96, 2, 12, False, 1.5, 16), (80, 1, 10, True, 3.0, 32), (128, 10, 150, False, 2.0, 256)],
)
def test_tiled_model_matches_plain(nxos, C, npe, exact, kw, item_rows):
    """The sliced contraction equals the plain gridder to fp32 grouping,
    split tiles (short items) and partial edge tiles included."""
    beta = kb_beta(kw, 2.0)
    rng = np.random.default_rng(nxos + npe)
    nR = nxos * 3 // 4 if exact else nxos
    planes = torch.from_numpy(rng.standard_normal((npe, nR, 2 * C), dtype=np.float32))
    planes[: npe // 2] *= -1
    angles = torch.from_numpy(np.asarray(jangles(npe, "golden", 19000 + nxos)))
    rad = lattice_radii(nR, nxos) if exact else None
    got = tiled_grid(planes, angles, nxos, kw, beta, rad=rad, item_rows=item_rows)
    if exact:
        # the dense raw-rows form of the same sum (row 0 dropped)
        d = torch.view_as_complex(planes.reshape(npe, nR, C, 2).permute(2, 0, 1, 3).contiguous())
        want = grid.grid_radial2d(grid.drop_readout0(d), angles, nxos, kw, beta, raw_rows=True)
    else:
        want = grid.grid_radial2d_planes_plain(planes, angles, nxos, kw, beta)
    assert nrmse(got.numpy(), want.numpy()) <= TOL


@pytest.mark.parametrize(
    "C,npe,nxos,scheme,skip",
    [(2, 12, 256, JAngleScheme.GOLDEN, 20055), (1, 16, 256, JAngleScheme.LINEAR_HALF, 0)],
)
def test_tiled_model_matches_jax_win_kernel(C, npe, nxos, scheme, skip):
    """The model vs JAX's windowed gridder (`_win_kernel`, float32,
    interpret mode), from the same complex samples through the port's
    sample prep; short items so that the centre tiles split."""
    rng = np.random.default_rng(npe + nxos)
    d = (rng.standard_normal((C, npe, nxos)) + 1j * rng.standard_normal((C, npe, nxos))).astype(np.complex64)
    d[:, : npe // 2] *= -1
    ang = np.asarray(jangles(npe, scheme, skip))
    beta = kb_beta(2.0, 2.0)
    want = np.asarray(
        jgrid_pallas.grid_radial2d_pallas(
            jnp.asarray(d), jnp.asarray(ang), nxos, 2.0, beta, pe_chunk=4, tile=128,
            matmul_dtype="float32", interpret=True,
        )
    )
    planes = grid_cuda.to_sample_planes(torch.from_numpy(d), nxos)
    got = tiled_grid(planes, torch.from_numpy(ang), nxos, 2.0, beta, item_rows=48)
    assert nrmse(got.numpy(), want) <= TOL


def test_tiled_model_matches_jax_exact_lattice():
    """The model on the exact lattice vs `grid_radial2d_pallas_exact`
    (gridos 1.5: nro 512 readouts on an nxos 384 grid), readout 0 zeroed as
    the kernels never grid it."""
    rng = np.random.default_rng(3)
    nro, nxos, npe = 512, 384, 6
    beta = kb_beta(2.0, 1.5)
    d = (rng.standard_normal((1, npe, nro)) + 1j * rng.standard_normal((1, npe, nro))).astype(np.complex64)
    d[..., 0] = 0
    ang = np.asarray(jangles(npe, JAngleScheme.GOLDEN, 5))
    want = np.asarray(
        jgrid_pallas.grid_radial2d_pallas_exact(
            jnp.asarray(d), jnp.asarray(ang), nxos, 2.0, beta, pe_chunk=4,
            matmul_dtype="float32", interpret=True,
        )
    )
    planes = grid_cuda._planes(torch.from_numpy(d))
    got = tiled_grid(planes, torch.from_numpy(ang), nxos, 2.0, beta,
                     rad=lattice_radii(nro, nxos), item_rows=64)
    assert nrmse(got.numpy(), want) <= TOL


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to TF32's 10 mantissa bits, to
    nearest with ties away from zero (half a TF32 ulp added to the
    magnitude bits, the 13 bits below cleared)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """x = hi + lo, each a TF32 value (B5's operand split)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def mma_tiled_grid(planes, angles, nxos, kw, beta, rad=None, item_rows=256, passes=3):
    """A torch model of B5's pass 3: per tile and item, rows staged in chunks
    of 128, each padded to a multiple of 32 with zero rows (every row
    contracted, none skipped), then static 8-row k-steps of the product
    A^T U, A = the x-weights at the tile's 16 columns, U = s (x) y-weights
    formed in fp32, N = (tile row, channel).  ``passes`` 3: the 3xTF32
    split, hi*lo, lo*hi, hi*hi accumulated in fp32 in that order; 1: one
    TF32 product.  Items' sums added in order; (C, nxos, nxos) complex64
    scaled by 1/(nxos*npe)."""
    npe, nR, K = planes.shape
    T = cull.TILE
    exact = rad is not None
    rr = rad if exact else _radii(nxos, nR, False)
    first, last = cull.tile_bands(angles, nxos, kw, nR if exact else None)
    items = cull.work_items(first, last, item_rows)
    ct, st_ = torch.cos(angles), torch.sin(angles)
    ntx = first.shape[1]
    coord = (torch.arange(ntx * T) - nxos // 2).to(torch.float32)
    out = planes.new_zeros((K, ntx * T, ntx * T))
    for t, its in enumerate(items):
        i, j = divmod(t, ntx)
        ys, xs = slice(i * T, (i + 1) * T), slice(j * T, (j + 1) * T)
        spoke, row = _rows(first, last, i, j)
        r = rr[row]
        A = kb_kernel(r[:, None] * ct[spoke, None] - coord[xs], kw, beta)   # (rows, 16 x)
        wy = kb_kernel(r[:, None] * st_[spoke, None] - coord[ys], kw, beta)  # (rows, 16 y)
        U = (wy[:, :, None] * planes[spoke, row][:, None, :]).reshape(-1, T * K)
        acc = planes.new_zeros((T, T * K))
        for a, b in its:
            part = planes.new_zeros((T, T * K))
            for q0 in range(a, b, 128):
                n = min(128, b - q0)
                m = -(-n // 32) * 32
                Ac = torch.nn.functional.pad(A[q0:q0 + n], (0, 0, 0, m - n)).reshape(-1, 8, T)
                Uc = torch.nn.functional.pad(U[q0:q0 + n], (0, 0, 0, m - n)).reshape(-1, 8, T * K)
                ah, al = _split(Ac)
                bh, bl = _split(Uc)
                terms = ([torch.einsum("skx,skn->sxn", ah, bl), torch.einsum("skx,skn->sxn", al, bh)]
                         if passes == 3 else [])
                terms.append(torch.einsum("skx,skn->sxn", ah, bh))
                for s in range(Ac.shape[0]):
                    for p in terms:
                        part = part + p[s]
            acc = acc + part
        out[:, ys, xs] = acc.reshape(T, T, K).permute(2, 1, 0)
    out = out[:, :nxos, :nxos] * (1.0 / (nxos * npe))
    return torch.view_as_complex(out.reshape(K // 2, 2, nxos, nxos).permute(0, 2, 3, 1).contiguous())


def test_tf32_rounds_to_ten_mantissa_bits():
    """The emulated cvt.rna.tf32: 10 mantissa bits, ties away from zero, and
    a split whose hi + lo holds x to about 2^-21."""
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12, 3.0])
    assert _tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000, dtype=np.float32))
    hi, lo = _split(y)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2**-21
    assert float(((hi - y).abs() / y.abs()).max()) > 2**-13


@pytest.mark.parametrize(
    "nxos,C,npe,exact,kw,item_rows",
    [(64, 1, 8, False, 2.0, 256), (100, 3, 17, False, 2.0, 40), (128, 2, 30, True, 2.0, 64),
     (96, 2, 12, False, 1.5, 16), (80, 1, 10, True, 3.0, 300)],
)
def test_mma_model_matches_fp32_model_and_plain(nxos, C, npe, exact, kw, item_rows):
    """B5's 3xTF32 contraction is float32-grade: within 1e-6 NRMSE of the
    fp32 tile model and of the plain gridder, where one TF32 pass alone is
    off by more than 1e-5.  Split tiles (short items), chunks padded to 32
    rows (item_rows 300: a 128-row chunk and a 44-row one), partial edge
    tiles, the exact lattice."""
    beta = kb_beta(kw, 2.0)
    rng = np.random.default_rng(nxos + npe + 1)
    nR = nxos * 3 // 4 if exact else nxos
    planes = torch.from_numpy(rng.standard_normal((npe, nR, 2 * C), dtype=np.float32))
    planes[: npe // 2] *= -1
    angles = torch.from_numpy(np.asarray(jangles(npe, "golden", 19000 + nxos)))
    rad = lattice_radii(nR, nxos) if exact else None
    got = mma_tiled_grid(planes, angles, nxos, kw, beta, rad=rad, item_rows=item_rows)
    fp32 = tiled_grid(planes, angles, nxos, kw, beta, rad=rad, item_rows=item_rows)
    if exact:
        d = torch.view_as_complex(planes.reshape(npe, nR, C, 2).permute(2, 0, 1, 3).contiguous())
        want = grid.grid_radial2d(grid.drop_readout0(d), angles, nxos, kw, beta, raw_rows=True)
    else:
        want = grid.grid_radial2d_planes_plain(planes, angles, nxos, kw, beta)
    assert nrmse(got.numpy(), fp32.numpy()) <= 1e-6
    assert nrmse(got.numpy(), want.numpy()) <= 1e-6
    one = mma_tiled_grid(planes, angles, nxos, kw, beta, rad=rad, item_rows=item_rows, passes=1)
    assert nrmse(one.numpy(), want.numpy()) > 1e-5


@pytest.mark.parametrize(
    "C,npe,nxos,scheme,skip",
    [(2, 12, 256, JAngleScheme.GOLDEN, 20055), (1, 16, 256, JAngleScheme.LINEAR_HALF, 0)],
)
def test_batched_plain_matches_jax_batched_kernel(C, npe, nxos, scheme, skip):
    """The port's B5 path on the CPU (the wrapper with tuning.batched takes
    the plain gridder for a CPU tensor) and the model of its 3xTF32
    contraction vs JAX's `_win_kernel_batched` (KernelTuning(batched=True),
    float32, interpret mode), from the same complex samples: within 1e-5."""
    rng = np.random.default_rng(npe + nxos + 2)
    d = (rng.standard_normal((C, npe, nxos)) + 1j * rng.standard_normal((C, npe, nxos))).astype(np.complex64)
    d[:, : npe // 2] *= -1
    ang = np.asarray(jangles(npe, scheme, skip))
    beta = kb_beta(2.0, 2.0)
    want = np.asarray(
        jgrid_pallas.grid_radial2d_pallas(
            jnp.asarray(d), jnp.asarray(ang), nxos, 2.0, beta, pe_chunk=4, tile=128,
            matmul_dtype="float32", interpret=True, tuning=JKernelTuning(batched=True),
        )
    )
    got = grid_cuda.grid_radial2d(torch.from_numpy(d), torch.from_numpy(ang), nxos, 2.0, beta,
                                  tuning=KernelTuning(batched=True))
    assert nrmse(got.numpy(), want) <= TOL
    planes = grid_cuda.to_sample_planes(torch.from_numpy(d), nxos)
    model = mma_tiled_grid(planes, torch.from_numpy(ang), nxos, 2.0, beta, item_rows=48)
    assert nrmse(model.numpy(), want) <= TOL


def test_whole_body_decomposition():
    """At the whole-body geometry (nxos 512, 204 golden spokes, kw 2) the
    centre tiles list every spoke and ~25x the median tile's rows, and L =
    256 splits them into ~16 items: the imbalance the kernel is built for."""
    angles = torch.from_numpy(np.asarray(jangles(204, "golden", 19000)))
    first, last = cull.tile_bands(angles, 512, 2.0)
    n = torch.clamp(last - first + 1, min=0)
    rows = n.sum(-1)
    centre = rows[15:17, 15:17]
    assert int((n[15, 15] > 0).sum()) == 204
    assert float(centre.float().min()) > 20 * float(rows.float().median())
    items = cull.work_items(first, last, 256)
    assert max(len(its) for its in items) == -(-int(rows.max()) // 256)
