"""The library formulation of the kernels (`tron_tpu_torch/tools/library_call.py`:
the KB interpolation matrix as CSR, one ``torch.sparse.mm``) vs the port's
plain versions and JAX's dense gridder and its gather and dense degridders
(`tron_tpu/ops/grid.py:51`, `tron_tpu/ops/degrid.py:24,98`), on the CPU.

The call is the yardstick that ``chip_smoke.py`` times beside the
hand-written kernels; here it is held to the functions they compute, at
the kernels' tolerance (1e-5 NRMSE: the same fp32 terms summed in another
order), on both lattices, clip and wrap.  Inputs are numpy arrays from
seeds, handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu.kernels.kb import kb_kernel as jkb_kernel
from tron_tpu.ops import degrid as jdegrid
from tron_tpu.ops import grid as jgrid
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.ops import degrid_cuda, grid_cuda
from tron_tpu_torch.ops.degrid import degrid_radial2d, lattice_radii
from tron_tpu_torch.ops.grid import drop_readout0, grid_radial2d_planes_plain
from tron_tpu_torch.tools import library_call as lib

torch.set_num_threads(1)

TOL = 1e-5


def _data(seed, *shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.array(x))


def _support(pos, n, kw, beta, wrap):
    """Grid coordinates 0..n-1 in the KB support of each position, (..., n)
    booleans, from JAX's kb_kernel over every coordinate (the dense
    formulation's weights; wrap: the distance taken periodically)."""
    d = np.arange(n, dtype=np.float32) - pos[..., None]
    if wrap:
        d = np.mod(d + n / 2, n) - n / 2
    return np.asarray(jkb_kernel(jnp.asarray(d, jnp.float32), kw, beta)) != 0


@pytest.mark.parametrize("kw", [2.0, 3.0])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("nxos", [128, 256])
@pytest.mark.parametrize("lattice", ["integer", "exact"])
def test_grid_library_matches_plain_and_jax(lattice, nxos, C, kw):
    """grid = A^T @ sample planes: the planes gridder (B1's plain version)
    and JAX's dense gridder, integer radii (nro = nxos) or the exact lattice
    (nro = 3 nxos / 4, raw rows, readout 0 never gridded)."""
    npe = 6
    beta = kb_beta(kw, 2.0)
    ang = np.asarray(jangles(npe, "golden", 40))
    if lattice == "integer":
        d = _data(nxos + C, C, npe, nxos)
        planes = grid_cuda.to_sample_planes(_t(d), nxos)
        AT = lib.interp_matrix(_t(ang), nxos, nxos, kw, beta, transpose=True)
        plain = grid_radial2d_planes_plain(planes, _t(ang), nxos, kw, beta)
        want = jgrid.grid_radial2d(jnp.asarray(d), jnp.asarray(ang), nxos, kw, beta)
    else:
        nro = 3 * nxos // 4
        d = np.asarray(drop_readout0(_t(_data(nxos + C, C, npe, nro))))
        planes = grid_cuda._planes(_t(d))
        AT = lib.interp_matrix(_t(ang), nxos, lattice_radii(nro, nxos), kw, beta,
                               transpose=True)
        plain = grid_cuda.grid_radial2d_exact(_t(d), _t(ang), nxos, kw, beta)
        want = jgrid.grid_radial2d(jnp.asarray(d), jnp.asarray(ang), nxos, kw, beta,
                                   raw_rows=True)
    assert AT.layout == torch.sparse_csr and AT.col_indices().dtype == torch.int32
    assert AT.shape == (nxos * nxos, planes.shape[0] * planes.shape[1])
    got = lib.grid_output(lib.grid_library(planes, AT), nxos)
    assert got.shape == (C, nxos, nxos) and got.dtype == torch.complex64
    assert nrmse(got.numpy(), plain.numpy()) <= TOL
    assert nrmse(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("kw", [2.0, 3.0])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("wrap", [True, False])
def test_degrid_library_matches_plain_and_jax(wrap, n, C, kw):
    """samples = A @ grid planes: the gather (B3's plain version) and JAX's
    gather and dense degridders, wrapped or clipped."""
    npe, nro = 6, n
    beta = kb_beta(kw, 2.0)
    ang = np.asarray(jangles(npe, "golden", 7))
    g = _data(n + C, C, n, n)
    A = lib.interp_matrix(_t(ang), n, nro, kw, beta, wrap=wrap)
    assert A.shape == (npe * nro, n * n)
    got = lib.degrid_output(lib.degrid_library(degrid_cuda.to_grid_planes(_t(g)), A),
                            npe, nro)
    assert got.shape == (C, npe, nro) and got.dtype == torch.complex64
    plain = degrid_radial2d(_t(g), _t(ang), nro, kw, beta, wrap=wrap)
    assert nrmse(got.numpy(), plain.numpy()) <= TOL
    for backend in ("gather", "dense"):
        want = jdegrid.degrid_radial2d(jnp.asarray(g), jnp.asarray(ang), nro, kw, beta,
                                       backend=backend, wrap=wrap)
        assert nrmse(got.numpy(), np.asarray(want)) <= TOL, backend


@pytest.mark.parametrize("case", ["grid integer", "grid exact", "degrid clip", "degrid wrap"])
def test_nonzeros_are_the_in_support_pairs(case):
    """One stored weight per (sample, pixel) pair in the KB support, counted
    over every pixel from JAX's dense weights: nothing outside the support
    and no pair twice."""
    n, npe, kw = 64, 5, 2.0
    beta = kb_beta(kw, 2.0)
    ang = np.asarray(jangles(npe, "golden", 3)).astype(np.float32)
    ct, st = np.cos(ang), np.sin(ang)
    if case.startswith("grid"):
        rad = (lattice_radii(48, n) if case.endswith("exact")
               else torch.arange(n, dtype=torch.float32) - n // 2)
        r = rad.numpy()
        A = lib.interp_matrix(_t(ang), n, rad if case.endswith("exact") else n, kw, beta,
                              transpose=True)
        # centred pixels: positions shifted by n//2 onto the indices 0..n-1
        cx = _support(r[None, 1:] * ct[:, None] + n // 2, n, kw, beta, False).sum(-1)
        cy = _support(r[None, 1:] * st[:, None] + n // 2, n, kw, beta, False).sum(-1)
    else:
        wrap = case.endswith("wrap")
        r = lattice_radii(n, n).numpy()
        A = lib.interp_matrix(_t(ang), n, n, kw, beta, wrap=wrap)
        cx = _support(r[None, :] * ct[:, None] + n // 2, n, kw, beta, wrap).sum(-1)
        cy = _support(r[None, :] * st[:, None] + n // 2, n, kw, beta, wrap).sum(-1)
    nnz = A.values().numel()
    assert nnz == int((cx * cy).sum())
    assert lib.matrix_bytes(A) == nnz * 8 + (A.shape[0] + 1) * 4


def test_wrapped_footprint_on_a_tiny_grid_sums_its_duplicates():
    """kw 3 on an 4 x 4 grid: a wrapped window of 7 neighbours holds a
    pixel up to twice per axis; the matrix sums them, as the gather does."""
    n, npe, nro, kw = 4, 3, 6, 3.0
    beta = kb_beta(kw, 2.0)
    ang = _t(np.asarray(jangles(npe, "golden", 1)))
    g = _t(_data(4, 2, n, n))
    A = lib.interp_matrix(ang, n, nro, kw, beta, wrap=True)
    assert A.values().numel() <= npe * nro * n * n
    got = lib.degrid_output(lib.degrid_library(degrid_cuda.to_grid_planes(g), A), npe, nro)
    assert nrmse(got.numpy(), degrid_radial2d(g, ang, nro, kw, beta, wrap=True).numpy()) <= TOL


def test_int32_indices_bytes_and_wrap_argument():
    """int32 indices; a product's bytes are the matrix's (4-byte values and
    column indices, rows + 1 row pointers) plus its operand and result."""
    ang = _t(np.asarray(jangles(4, "golden", 0)))
    beta = kb_beta(2.0, 2.0)
    A = lib.interp_matrix(ang, 32, 32, 2.0, beta)
    assert A.col_indices().dtype == A.crow_indices().dtype == torch.int32
    nnz = A.values().numel()
    assert lib.spmm_bytes(A, 4) == 8 * nnz + 4 * (4 * 32 + 1) + 4 * 4 * (32 * 32 + 4 * 32)
    with pytest.raises(ValueError, match="wrap"):
        lib.interp_matrix(ang, 32, 32, 2.0, beta, wrap=True, transpose=True)


@pytest.mark.parametrize("op", ["grid", "degrid"])
def test_kbench_library_route_on_cpu(op):
    """kbench --library at a tiny size on the CPU (its timing needs the
    card): one sparse product per frame, complex in and out as the wrappers
    take them, against the plain version at float32."""
    from tron_tpu_torch.tools import kbench

    argv = ["--frames", "2", "--nc", "2", "--nro", "64", "--npe", "12", "--dtype", "float32",
            "--library", "--op", op]
    fn, plain, _ = kbench.make_case(kbench.build_parser().parse_args(argv), torch.device("cpu"))
    for f in range(2):
        assert kbench.nrmse(fn(f), plain(f)) <= TOL
