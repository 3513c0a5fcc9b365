"""The precision classes (``matmul_dtype``) of the port's kernels, through
their plain versions on the CPU, vs the JAX kernels at the same class.

Each Pallas kernel runs in interpret mode, as the JAX package's own tests
run it (tests/test_grid_pallas.py, tests/test_degrid_pallas.py); the port's
wrappers take their plain versions for a CPU tensor, at the class they are
handed.  Inputs are numpy arrays from seeds, handed to both packages.

Bounds (NRMSE against JAX at the class): 1e-5 for bf16x3 and float32, the
fp32 bound of the JAX tests.  3e-4 for bfloat16 and bf16x2: both sides round
the same operands, but the KB weights and sample coordinates are evaluated
in other fp32 operation orders (JAX's windowed, segmented and degridding
kernels take a Taylor polynomial in q and centred coordinates, the port the
rational I0 of kernels/kb.py and the gather's coordinates), and a weight a
few ulp away rounds to another bfloat16 now and then (`test_kb_bf16_flips`);
each such flip moves its terms by a bfloat16 ulp, while a port that stayed
fp32 would sit at the class's whole rounding error, ~2e-3 away.  The class
is also held to its effect: the port's error against its own float32 lies
within [0.5, 2] times JAX's against JAX's.

    JAX_PLATFORMS=cpu python -m tests.test_torch_precision

prints each case's NRMSE per class and the flip rate.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu.config import KernelTuning as JaxTuning
from tron_tpu.ops import degrid_pallas as jdegrid_pallas
from tron_tpu.ops import grid_pallas as jgrid_pallas
from tron_tpu.ops.grid_pallas import _kb_poly, _kb_taylor_coeffs
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch import nufft
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.kernels.kb import kb_beta, kb_kernel
from tron_tpu_torch.ops import degrid_cuda, grid_cuda, precision
from tron_tpu_torch.recon import recon_radial2d

torch.set_num_threads(1)

KW = 2.0
BETA = kb_beta(KW, 2.0)
CLASSES = ("bfloat16", "bf16x2", "bf16x3", "float32")
TOL = {"bfloat16": 3e-4, "bf16x2": 3e-4, "bf16x3": 1e-5, "float32": 1e-5}


def _cplx(rng, *shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _b1(batched):
    """B1 (or B5): the planes entry at nxos 256, vs grid_radial2d_pallas_planes."""
    nxos, npe = 256, 12
    rng = np.random.default_rng(5 if batched else 4)
    d = _cplx(rng, 2, npe, nxos)
    d[:, : npe // 2] *= -1  # an incremental delta's signs
    ang = np.asarray(jangles(npe, "golden", 20055))
    jpl = jgrid_pallas.to_sample_planes(jnp.asarray(d), nxos)

    def jax_(c):
        return jgrid_pallas.grid_radial2d_pallas_planes(
            jpl, jnp.asarray(ang), nxos, KW, BETA, matmul_dtype=c, interpret=True,
            tuning=JaxTuning(batched=batched),
        )

    def port(c):
        return grid_cuda.grid_radial2d_planes(_t(jpl), _t(ang), nxos, KW, BETA, matmul_dtype=c)

    return jax_, port


def _exact():
    """B1's exact lattice (nro 384 on nxos 256), vs grid_radial2d_pallas_exact;
    readout 0 is zeroed, as nufft_adjoint_exact zeroes it for JAX."""
    nxos, npe, nro = 256, 12, 384
    d = _cplx(np.random.default_rng(6), 1, npe, nro)
    d[..., 0] = 0
    ang = np.asarray(jangles(npe, "golden", 311))

    def jax_(c):
        return jgrid_pallas.grid_radial2d_pallas_exact(
            jnp.asarray(d), jnp.asarray(ang), nxos, KW, BETA, matmul_dtype=c, interpret=True
        )

    def port(c):
        return grid_cuda.grid_radial2d_exact(_t(d), _t(ang), nxos, KW, BETA, matmul_dtype=c)

    return jax_, port


def _seg():
    """B4: windowed=False at nxos 256, vs _seg_kernel."""
    nxos, npe = 256, 16
    d = _cplx(np.random.default_rng(7), 2, npe, nxos)
    ang = np.asarray(jangles(npe, "golden", 9))

    def jax_(c):
        return jgrid_pallas.grid_radial2d_pallas(
            jnp.asarray(d), jnp.asarray(ang), nxos, KW, BETA, matmul_dtype=c, interpret=True,
            windowed=False,
        )

    def port(c):
        return grid_cuda.grid_radial2d(_t(d), _t(ang), nxos, KW, BETA, matmul_dtype=c,
                                       windowed=False)

    return jax_, port


def _full(nxos):
    """B2: grids that do not tile (nxos 64 and 128), vs _grid_kernel."""
    npe = 12
    d = _cplx(np.random.default_rng(nxos), 2, npe, nxos)
    ang = np.asarray(jangles(npe, "golden", 5))

    def jax_(c):
        return jgrid_pallas.grid_radial2d_pallas(
            jnp.asarray(d), jnp.asarray(ang), nxos, KW, BETA, matmul_dtype=c, interpret=True
        )

    def port(c):
        return grid_cuda.grid_radial2d(_t(d), _t(ang), nxos, KW, BETA, matmul_dtype=c)

    return jax_, port


def _degrid():
    """B3 in clip mode at nxos 256, vs _degrid_kernel."""
    n, npe = 256, 12
    g = _cplx(np.random.default_rng(21), 2, n, n)
    ang = np.asarray(jangles(npe, "golden", 7))

    def jax_(c):
        return jdegrid_pallas.degrid_radial2d_pallas(
            jnp.asarray(g), jnp.asarray(ang), n, KW, BETA, pe_chunk=4, matmul_dtype=c,
            interpret=True,
        )

    def port(c):
        return degrid_cuda.degrid_radial2d(_t(g), _t(ang), n, KW, BETA, matmul_dtype=c,
                                           wrap=False)

    return jax_, port


CASES = {
    "B1": functools.partial(_b1, False),
    "B1-exact": _exact,
    "B5": functools.partial(_b1, True),
    "B4": _seg,
    "B2-64": functools.partial(_full, 64),
    "B2-128": functools.partial(_full, 128),
    "B3": _degrid,
}


@functools.cache
def _results(case: str) -> dict:
    """Both packages' outputs of one case at every class, as numpy."""
    jax_, port = CASES[case]()
    return {c: (np.asarray(jax_(c)), port(c).numpy()) for c in CLASSES}


@pytest.mark.parametrize("matmul_dtype", CLASSES)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_pallas_at_the_class(case, matmul_dtype):
    res = _results(case)
    want, got = res[matmul_dtype]
    assert got.dtype == np.complex64 and got.shape == want.shape
    err = nrmse(got, want)
    assert err <= TOL[matmul_dtype], f"{case} {matmul_dtype}: port vs JAX nrmse {err:.3e}"
    # the class is applied: the port's own rounding error against its float32
    # is JAX's against JAX's float32, within a factor of 2
    mine = nrmse(got, res["float32"][1])
    theirs = nrmse(want, res["float32"][0])
    if theirs == 0.0:  # float32, and the classes that B2 and B4 run as another
        assert mine == 0.0 or nrmse(got, res["bf16x3"][1]) == 0.0
    else:
        assert 0.5 * theirs <= mine <= 2.0 * theirs, (case, matmul_dtype, mine, theirs)


@pytest.mark.parametrize("case", ["B1", "B5", "B4", "B3"])
def test_bf16x3_beats_bfloat16(case):
    res = _results(case)
    ref = res["float32"][1]
    assert nrmse(res["bf16x3"][1], ref) < 0.01 * nrmse(res["bfloat16"][1], ref)


def test_seg_kernel_takes_bf16x2_as_bf16x3():
    """grid_pallas.py:735-738: _seg_kernel runs bf16x2 as its 3-pass class."""
    res = _results("B4")
    np.testing.assert_array_equal(res["bf16x2"][1], res["bf16x3"][1])
    assert nrmse(res["bf16x2"][0], res["bf16x3"][0]) == 0.0
    assert grid_cuda.gridder_class(256, "bf16x2", windowed=False) == ("bf16x3", False)
    assert grid_cuda.gridder_class(256, "bf16x2") == ("bf16x2", False)


@pytest.mark.parametrize("nxos", [64, 128])
def test_full_kernel_rule(nxos):
    """grid_pallas.py:832-833: on a grid that does not tile, bfloat16 rounds
    the samples first and every other class is fp32."""
    res = _results(f"B2-{nxos}")
    for c in ("bf16x2", "bf16x3"):
        np.testing.assert_array_equal(res[c][1], res["float32"][1])
        assert nrmse(res[c][0], res["float32"][0]) == 0.0
    assert nrmse(res["bfloat16"][1], res["float32"][1]) > 1e-3
    assert grid_cuda.gridder_class(nxos, "bfloat16") == ("bfloat16", True)
    assert grid_cuda.gridder_class(nxos, "bf16x3", windowed=False) == ("float32", False)
    # the exact lattice there is JAX's dense raw-rows gridder: no class
    assert grid_cuda.gridder_class(nxos, "bfloat16", exact=True) == ("float32", False)


def test_planes_entry_takes_the_full_kernel_rule():
    """The port's main path grids nxos 128 from sample planes, where JAX
    calls grid_radial2d_pallas (B2): the planes entry applies the same rule."""
    nxos, npe = 128, 12
    d = torch.from_numpy(_cplx(np.random.default_rng(128), 2, npe, nxos))
    ang = _t(jangles(npe, "golden", 5))
    planes = grid_cuda.to_sample_planes(d, nxos)
    for c in CLASSES:
        want = grid_cuda.grid_radial2d(d, ang, nxos, KW, BETA, pe_chunk=8, matmul_dtype=c)
        got = grid_cuda.grid_radial2d_planes(planes, ang, nxos, KW, BETA, matmul_dtype=c)
        assert nrmse(got.numpy(), want.numpy()) <= 1e-6, c


@pytest.mark.parametrize("matmul_dtype", CLASSES)
def test_class_dot_is_exact_products_summed_in_fp32(matmul_dtype):
    """precision.class_dot against the same splits summed in float64: the
    only error left is the fp32 sums'."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((64, 200), dtype=np.float32))
    a = torch.from_numpy(rng.standard_normal((200, 48), dtype=np.float32))
    got = precision.class_dot(u, a, matmul_dtype)
    uh, ah = precision.bf16(u), precision.bf16(a)
    ul, al = precision.bf16(u - uh), precision.bf16(a - ah)
    terms = {"bfloat16": [(uh, ah)], "bf16x2": [(uh, ah), (uh, al)],
             "bf16x3": [(uh, ah), (ul, ah), (uh, al)], "float32": [(u, a)]}[matmul_dtype]
    want = sum(x.double() @ y.double() for x, y in terms)
    assert nrmse(got.double().numpy(), want.numpy()) <= 1e-6
    exact = u.double() @ a.double()
    grade = {"bfloat16": 3e-3, "bf16x2": 3e-3, "bf16x3": 2e-5, "float32": 1e-6}[matmul_dtype]
    assert nrmse(got.double().numpy(), exact.numpy()) <= grade


def test_kernel_class_routing():
    """nufft.kernel_class: the card takes cfg.matmul_dtype, the CPU float32
    (JAX's auto backend off the TPU has no class)."""
    cfg = ReconConfig()
    assert cfg.matmul_dtype == "bfloat16"
    assert nufft.kernel_class(cfg, torch.device("cpu")) == "float32"
    assert nufft.kernel_class(cfg, torch.device("cuda", 0)) == "bfloat16"
    acc = dataclasses.replace(cfg, matmul_dtype="bf16x3")
    assert nufft.kernel_class(acc, torch.device("cuda", 0)) == "bf16x3"


@pytest.mark.parametrize("mode", ["direct", "incremental", "forward", "cgnr"])
def test_cpu_main_path_is_its_float32_run(mode):
    """Under the default config (bfloat16) the CPU main path is bitwise its
    matmul_dtype="float32" run: the CPU runs JAX's classless path."""
    nro, npe1 = 64, 60
    rng = np.random.default_rng(11)
    if mode == "forward":
        data = _cplx(rng, 2, 1, nro // 2, nro // 2, 2)
        cfg = ReconConfig(golden_angle=True)
    else:
        data = np.transpose(_cplx(rng, 2, npe1, nro), (0, 2, 1))[:, None]
        cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=8, adjoint=True,
                          incremental=mode == "incremental", niter=2 if mode == "cgnr" else 0)
    got = recon_radial2d(data, cfg, device=torch.device("cpu"))
    want = recon_radial2d(data, dataclasses.replace(cfg, matmul_dtype="float32"),
                          device=torch.device("cpu"))
    np.testing.assert_array_equal(got, want)


def _flip_rate(n=1_000_000) -> float:
    """The share of KB weights on n offsets in (-kw, kw) whose bfloat16
    rounding differs between the port's kb_kernel and JAX's kernels'
    Taylor polynomial `_kb_poly`."""
    x = np.linspace(-KW, KW, n, dtype=np.float32)[1:-1]
    port = precision.bf16(kb_kernel(torch.from_numpy(x), KW, BETA))
    jax_ = precision.bf16(_t(_kb_poly(jnp.asarray(x), KW, _kb_taylor_coeffs(KW, BETA))))
    return float((port != jax_).double().mean())


def test_kb_bf16_flips():
    """Why the bf16 classes sit farther from JAX than the fp32 ones: JAX's
    kernels evaluate KB by a Taylor polynomial, the port by the rational
    I0, and the two round to another bfloat16 on a small share of the
    weights."""
    assert 0.0 < _flip_rate() < 2e-4


if __name__ == "__main__":
    for case in CASES:
        res = _results(case)
        print(case, " ".join(f"{c} {nrmse(got, want):.2e} (own {nrmse(got, res['float32'][1]):.2e})"
                             for c, (want, got) in res.items()))
    print(f"KB weights rounding to another bfloat16: {_flip_rate():.2e}")
