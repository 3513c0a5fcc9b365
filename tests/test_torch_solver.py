"""The port's CGNR solver (tron_tpu_torch.solver), its exact DTFT oracle and
the numpy-only copies (phantom, metrics) vs the JAX package on the CPU, at
the sizes of tests/test_solver.py.  Inputs are numpy arrays from seeds,
handed to both packages.  On the CPU the "pair" mode runs the kernels'
plain versions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import lmse, nrmse
from tron_tpu import metrics as jmetrics
from tron_tpu import nufft as jnufft
from tron_tpu import phantom as jphantom
from tron_tpu import solver as jsolver
from tron_tpu.config import AngleScheme
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.oracle import dtft as jdtft
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch import metrics, nufft, phantom, solver
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.oracle import dtft

torch.set_num_threads(1)

TOL = 1e-4  # CGNR vs JAX, NRMSE: fp32 sums in other orders over the iterations


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _problem(n, npe, gridos=2.0, nro=None):
    """Shepp-Logan data from JAX's own forward (tests/test_solver.py)."""
    jcfg = JaxConfig(angle_scheme=AngleScheme.LINEAR_HALF, gridos=gridos)
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))
    img = jphantom.shepp_logan(n)
    ang = np.asarray(jangles(npe, AngleScheme.LINEAR_HALF))
    data = np.asarray(jnufft.nufft_forward(jnp.asarray(img), jnp.asarray(ang), jcfg, nro=nro))
    return jcfg, cfg, img, ang, data


def _cg64(normal, b, niter):
    """CGNR in float64 on the port's own normal operator, built column by
    column as a dense matrix: exact arithmetic for the CG recurrences."""
    n2 = b.numel()
    eye = torch.eye(n2, dtype=b.dtype).reshape((n2,) + tuple(b.shape))
    M = torch.stack([normal(e).reshape(-1) for e in eye], dim=1).to(torch.complex128)
    x = torch.zeros(n2, dtype=torch.complex128)
    r = b.reshape(-1).to(torch.complex128)
    p = r.clone()
    rs = torch.vdot(r, r).real
    for _ in range(niter):
        Ap = M @ p
        alpha = rs / torch.vdot(p, Ap).real
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.vdot(r, r).real
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x.reshape(b.shape).numpy()


@pytest.mark.parametrize("operators", ["pair", "transpose", "toeplitz"])
def test_cgnr_matches_jax(operators):
    jcfg, cfg, img, ang, data = _problem(32, 24)
    want = np.asarray(
        jsolver.cgnr_radial2d(jnp.asarray(data), jnp.asarray(ang), jcfg, niter=8,
                              operators=operators)
    )
    got = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=8, operators=operators)
    assert got.shape == (32, 32) and got.dtype == torch.complex64
    assert nrmse(got.numpy(), want) <= TOL
    adj = nufft.nufft_adjoint(_t(data), _t(ang), cfg).numpy()
    assert lmse(got.numpy(), img) < lmse(adj, img)  # tests/test_solver.py:17-31


@pytest.mark.parametrize("operators", ["pair", "transpose"])
@pytest.mark.parametrize("gridos", [1.5, 2.5])
def test_cgnr_nondefault_gridos(gridos, operators):
    """tests/test_solver.py:169-190, held to JAX at TOL.  Each CG loop is
    also held to float64 CG on its own normal operator: at n 32, npe 24,
    gridos 1.5 JAX's loop drifts 2.1e-2 from that (its first step size is
    1.5e-5 off, and the problem amplifies it), while the port stays within
    8e-7; here (n 24, npe 20) JAX is 4.3e-5 from it and the port 9e-7."""
    n, npe = 24, 20
    jcfg, cfg, img, ang, data = _problem(n, npe, gridos, nro=2 * n)
    want = np.asarray(
        jsolver.cgnr_radial2d(jnp.asarray(data), jnp.asarray(ang), jcfg, niter=6,
                              operators=operators)
    )
    got = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=6, operators=operators)
    assert nrmse(got.numpy(), want) <= TOL
    if gridos == 1.5:
        w = solver._weights(cfg, 2 * n, npe, "cpu").to(torch.complex64)
        AHW, normal = solver._operators(_t(ang), cfg, 2 * n, (n, n), w, operators)
        assert nrmse(got.numpy(), _cg64(normal, AHW(_t(data)), 6)) <= 1e-5
    adj = nufft.nufft_adjoint(_t(data), _t(ang), cfg).numpy()
    assert lmse(got.numpy(), img) < lmse(adj, img)


def test_cgnr_monotone_data_residual():
    """tests/test_solver.py:34-46."""
    _, cfg, _, ang, data = _problem(24, 16)
    prev = np.inf
    for it in [1, 4, 12]:
        x = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=it)
        resid = float(torch.linalg.vector_norm(nufft.nufft_forward(x, _t(ang), cfg) - _t(data)))
        assert resid < prev * 1.01
        prev = resid


def test_cgnr_stops_at_rtol_and_dispatch():
    _, cfg, _, ang, data = _problem(24, 16)
    x0 = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=0)
    assert not x0.any()
    # a loose tolerance stops the loop early: more iterations change nothing
    a = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=3, rtol=0.5)
    b = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=30, rtol=0.5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        solver.cgnr_or_adjoint(_t(data), _t(ang), dataclasses.replace(cfg, niter=4)).numpy(),
        solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=4).numpy(),
    )
    np.testing.assert_array_equal(
        solver.cgnr_or_adjoint(_t(data), _t(ang), cfg).numpy(),
        nufft.nufft_adjoint(_t(data), _t(ang), cfg).numpy(),
    )
    flag = solver.cgnr_radial2d(_t(data), _t(ang), dataclasses.replace(cfg, toeplitz=True),
                                niter=4)
    tp = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=4, operators="toeplitz")
    np.testing.assert_array_equal(flag.numpy(), tp.numpy())
    with pytest.raises(ValueError, match="operators"):
        solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=1, operators="dense")


def test_transpose_mode_is_the_adjoint():
    """Dot test of the autograd adjoint: <y, A x> = <A^H y, x> with no
    conjugation around the vjp."""
    n, npe = 16, 9
    cfg = ReconConfig(golden_angle=True, backend="jnp")
    ang = _t(np.asarray(jangles(npe, "golden", 3)))
    rng = np.random.default_rng(4)
    x = _t((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64))
    y = _t((rng.standard_normal((npe, 2 * n)) + 1j * rng.standard_normal((npe, 2 * n)))
           .astype(np.complex64))

    def fwd(v):
        return nufft.nufft_forward(v, ang, cfg, nro=2 * n)

    AHy = solver._transpose_adjoint(fwd, (n, n), torch.complex64, "cpu")(y)
    lhs = complex(torch.vdot(y.reshape(-1), fwd(x).reshape(-1)))
    rhs = complex(torch.vdot(AHy.reshape(-1), x.reshape(-1)))
    assert abs(lhs - rhs) / abs(rhs) < 1e-5


@pytest.mark.parametrize(
    "kw",
    [dict(reduce_axes=("coil",)), dict(spoke_axis="spoke"), dict(npe_total=40),
     dict(sample_mask=torch.ones(16))],
)
def test_multi_device_arguments_raise(kw):
    """The multi-device arguments run (they raised until `parallel/` was
    ported).  A mesh axis is a MeshAxis handle, which carries the process
    group: on an axis of one rank it changes no bit, a bare axis name
    raises, and so does a spoke axis that is also reduced over.  npe_total
    and sample_mask weigh as tron_tpu/solver.py:83-86, 214-216 do: JAX's
    results at TOL (on golden angles: with linear_half spoke 0 lies on a grid
    row, where one ulp moves a window's edge neighbour)."""
    from tron_tpu_torch.parallel.distributed import MeshAxis

    jcfg = JaxConfig(golden_angle=True)
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))
    ang = np.asarray(jangles(16, AngleScheme.GOLDEN, 3))
    rng = np.random.default_rng(9)
    data = (rng.standard_normal((2, 16, 48)) + 1j * rng.standard_normal((2, 16, 48))).astype(
        np.complex64)
    base = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=2)
    if "reduce_axes" in kw or "spoke_axis" in kw:
        with pytest.raises(TypeError, match="MeshAxis"):
            solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=2, **kw)
        axes = {k: (MeshAxis(v[0]),) if k == "reduce_axes" else MeshAxis(v) for k, v in kw.items()}
        got = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=2, **axes)
        np.testing.assert_array_equal(got.numpy(), base.numpy())
        with pytest.raises(ValueError, match="must not also be in reduce_axes"):
            solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=2, spoke_axis=MeshAxis("spoke"),
                                 reduce_axes=(MeshAxis("spoke"),))
        return
    jkw = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    for operators in ("pair", "transpose", "toeplitz"):
        want = np.asarray(jsolver.cgnr_radial2d(jnp.asarray(data), jnp.asarray(ang), jcfg, niter=2,
                                                operators=operators, **jkw))
        got = solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=2, operators=operators, **kw)
        assert nrmse(got.numpy(), want) <= TOL
    # an all-ones mask weighs nothing out; another frame's spoke count does
    assert ("sample_mask" in kw) == bool(np.array_equal(got.numpy(), solver.cgnr_radial2d(
        _t(data), _t(ang), cfg, niter=2, operators="toeplitz").numpy()))
    want = np.asarray(jsolver.toeplitz_fourier_kernel(jnp.asarray(ang), jcfg, 48, **jkw))
    assert nrmse(solver.toeplitz_fourier_kernel(_t(ang), cfg, 48, **kw).numpy(), want) <= 1e-5
    half = torch.arange(16) < 8
    masked = solver.toeplitz_fourier_kernel(_t(ang), cfg, 48, sample_mask=half)
    other = solver.toeplitz_fourier_kernel(_t(ang), cfg, 48, sample_mask=~half)
    whole = solver.toeplitz_fourier_kernel(_t(ang), cfg, 48)
    assert nrmse((masked + other).numpy(), whole.numpy()) <= 1e-6  # shards' kernels sum to the frame's


@pytest.mark.parametrize("method,n,npe", [("nufft", 32, 24), ("exact", 16, 11)])
def test_toeplitz_fourier_kernel_matches_jax(method, n, npe):
    jcfg = JaxConfig(golden_angle=True)
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))
    ang = np.asarray(jangles(npe, AngleScheme.GOLDEN, 0))
    want = np.asarray(jsolver.toeplitz_fourier_kernel(jnp.asarray(ang), jcfg, 2 * n, method=method))
    got = solver.toeplitz_fourier_kernel(_t(ang), cfg, 2 * n, method=method)
    assert got.shape == (2 * n, 2 * n)
    assert nrmse(got.numpy(), want) <= 1e-5
    x = (np.random.default_rng(5).standard_normal((2, n, n)) * (1 + 1j)).astype(np.complex64)
    np.testing.assert_allclose(
        solver.toeplitz_apply(_t(x), got).numpy(),
        np.asarray(jsolver.toeplitz_apply(jnp.asarray(x), jnp.asarray(want))),
        rtol=0, atol=1e-5 * float(np.abs(want).max()) * np.abs(x).max(),
    )


def test_toeplitz_nufft_method_requires_gridos2():
    """tests/test_solver.py:120-136."""
    cfg = ReconConfig(golden_angle=True, gridos=1.5)
    ang = _t(np.asarray(jangles(24, AngleScheme.GOLDEN, 0)))
    with pytest.raises(ValueError, match="gridos"):
        solver.toeplitz_fourier_kernel(ang, cfg, 64, method="nufft")
    exact = solver.toeplitz_fourier_kernel(ang, cfg, 64, method="exact")
    np.testing.assert_array_equal(solver.toeplitz_fourier_kernel(ang, cfg, 64).numpy(),
                                  exact.numpy())


def test_dtft_oracle_matches_jax():
    rng = np.random.default_rng(6)
    n, nos, m = 12, 24, 300
    img = (rng.standard_normal((2, n, n)) + 1j * rng.standard_normal((2, n, n))).astype(
        np.complex64)
    kx = (rng.uniform(-nos / 2, nos / 2, m)).astype(np.float32)
    ky = (rng.uniform(-nos / 2, nos / 2, m)).astype(np.float32)
    s = (rng.standard_normal((2, m)) + 1j * rng.standard_normal((2, m))).astype(np.complex64)
    want = np.asarray(jdtft.dtft2(jnp.asarray(img), jnp.asarray(kx), jnp.asarray(ky), nos))
    assert nrmse(dtft.dtft2(_t(img), _t(kx), _t(ky), nos).numpy(), want) <= 1e-5
    want = np.asarray(jdtft.dtft2_adjoint_chunked(jnp.asarray(s), jnp.asarray(kx),
                                                  jnp.asarray(ky), n, nos, chunk=128))
    got = dtft.dtft2_adjoint_chunked(_t(s), _t(kx), _t(ky), n, nos, chunk=128)
    assert nrmse(got.numpy(), want) <= 1e-5
    assert nrmse(dtft.dtft2_adjoint(_t(s), _t(kx), _t(ky), n, nos).numpy(), want) <= 1e-5


def test_oracle_adjoint_recon_matches_jax():
    jcfg = JaxConfig(golden_angle=True)
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7)
    nro, npe = 32, 10
    d = (rng.standard_normal((2, npe, nro)) + 1j * rng.standard_normal((2, npe, nro))).astype(
        np.complex64)
    ang = np.asarray(jangles(npe, AngleScheme.GOLDEN, 11))
    want = np.asarray(jdtft.oracle_adjoint_recon(jnp.asarray(d), jnp.asarray(ang), jcfg, 16, nro))
    got = dtft.oracle_adjoint_recon(_t(d), _t(ang), cfg, 16, nro)
    assert nrmse(got.numpy(), want) <= 1e-5


def test_phantom_and_metrics_copies_match_jax():
    for n in (24, 33):
        np.testing.assert_array_equal(phantom.shepp_logan(n), jphantom.shepp_logan(n))
        np.testing.assert_array_equal(phantom.birdcage_sensitivities(n, 6),
                                      jphantom.birdcage_sensitivities(n, 6))
    k = np.linspace(-20, 20, 41)
    np.testing.assert_array_equal(phantom.shepp_logan_kspace(k, k[::-1], 32),
                                  jphantom.shepp_logan_kspace(k, k[::-1], 32))
    rng = np.random.default_rng(8)
    a, b = rng.standard_normal((2, 20, 20)) + 1j * rng.standard_normal((2, 20, 20))
    for f in ("rmse", "nrmse", "nmse", "lmse", "ssim"):
        assert getattr(metrics, f)(a, b) == getattr(jmetrics, f)(a, b)
    np.testing.assert_array_equal(metrics.lmsediff(a, b), jmetrics.lmsediff(a, b))
