"""The port's CGNR solver (tron_tpu_torch.solver), its exact DTFT oracle and
the numpy-only copies (phantom, metrics) vs the JAX package on the CPU, at
the sizes of tests/test_solver.py.  Inputs are numpy arrays from seeds,
handed to both packages.  On the CPU the "pair" mode runs the kernels'
plain versions.
"""

import collections
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
from tron_tpu_torch import graphs, metrics, nufft, phantom, solver
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


def _step_case(seed: int):
    """A pair-mode CG state on the CPU after one step: (x, r, p, rs, normal)."""
    _, cfg, _, ang, data = _problem(24, 16)
    w = solver._weights(cfg, 48, 16, "cpu").to(torch.complex64)
    AHW, normal = solver._operators(_t(ang), cfg, 48, (24, 24), w, "pair")
    b = AHW(_t(data))
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b.shape, generator=g, dtype=torch.complex64)
    p = b + 0.1 * torch.randn(b.shape, generator=g, dtype=torch.complex64)
    return x, b.clone(), p, solver._inner(b, b), normal


def test_cg_step_while_live_is_the_cg_formula():
    """Where rs > thresh the shared step gives the CG formula's bits (the
    loop of the solver before its stop test moved to the device)."""
    x, r, p, rs, normal = _step_case(1)
    Ap = normal(p)
    alpha = rs / torch.clamp(torch.sum(torch.conj(p) * Ap).real, min=1e-30)
    want_x = x + alpha.to(x.dtype) * p
    want_r = r - alpha.to(r.dtype) * Ap
    want_rs = torch.sum(torch.conj(want_r) * want_r).real
    beta = want_rs / torch.clamp(rs, min=1e-30)
    want_p = want_r + beta.to(p.dtype) * p
    live = solver._cg_step(x, r, p, rs, torch.zeros(()), normal, solver._inner)
    assert live.dtype == torch.bool and bool(live)
    for got, want in ((x, want_x), (r, want_r), (p, want_p), (rs, want_rs)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("margin", [0.0, 1.0])
def test_cg_step_past_convergence_changes_no_bit(margin):
    """Where rs <= thresh (equal, or below) the shared step leaves x, r, p
    and rs bitwise as they were, in place, and counts no iteration."""
    x, r, p, rs, normal = _step_case(2)
    thresh = rs + margin
    before = [t.clone() for t in (x, r, p, rs)]
    ptrs = [t.data_ptr() for t in (x, r, p, rs)]
    count = torch.zeros((), dtype=torch.int64)
    count += solver._cg_step(x, r, p, rs, thresh, normal, solver._inner)
    assert int(count) == 0
    assert [t.data_ptr() for t in (x, r, p, rs)] == ptrs
    for got, want in zip((x, r, p, rs), before):
        assert torch.equal(got, want)


def test_cpu_solve_captures_nothing():
    """On the CPU every mode runs the eager loop: no graph is made, and the
    counts see each solve and its iterations."""
    _, cfg, _, ang, data = _problem(24, 16)
    solver.reset_cgnr_counts()
    solver.reset_cgnr_graph_counts()
    solver.reset_cgnr_prologue_counts()
    for operators in ("auto", "pair", "transpose", "toeplitz"):
        solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=3, operators=operators)
    assert solver.CGNR_GRAPH_COUNTS == {"captured": 0, "replayed": 0, "eager": 4}
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 0, "eager": 4}
    assert solver.cgnr_counts() == {"solves": 4, "iterations": 12}
    assert not solver._cg_graphs.entries


def test_cgnr_counts_fold_in_the_graphs_iterations(monkeypatch):
    """cgnr_counts()["iterations"] adds the device's count of graphed
    iterations (the int64 the captured step adds to; a CPU tensor here) to
    the eager loop's, also once the graphs that counted are dropped from
    the cache; a reset discards what was counted so far, the device's count
    zeroed in place (the captured steps hold its address)."""
    cpu = torch.device("cpu")
    live = torch.zeros((), dtype=torch.int64)
    monkeypatch.setattr(solver, "_live", {cpu: live})
    monkeypatch.setattr(solver._cg_graphs, "entries", collections.OrderedDict())
    solver.reset_cgnr_counts()
    _, cfg, _, ang, data = _problem(24, 16)
    solver.cgnr_radial2d(_t(data), _t(ang), cfg, niter=3)
    live += 7
    assert solver.cgnr_counts() == {"solves": 1, "iterations": 10}
    live += 5
    for k in range(graphs.KEPT + 1):  # the fifth geometry drops the first
        solver._cg_graphs.get(k, lambda: solver._CGGraph(_t(data), _t(ang), cfg, None, False, 1e-6))
    assert list(solver._cg_graphs.entries) == list(range(1, graphs.KEPT + 1))
    assert solver.cgnr_counts() == {"solves": 1, "iterations": 15}
    solver.reset_cgnr_counts()
    assert solver.cgnr_counts() == {"solves": 0, "iterations": 0}
    assert solver._live[cpu] is live and int(live) == 0


class _Rerun:
    """A captured graph's stand-in: a replay runs the function again and,
    as a replay runs no Python, leaves the multipliers' count as it was."""

    def __init__(self, fn, static):
        self.fn, self.static = fn, static

    def replay(self):
        built = dict(solver.TOEPLITZ_COUNTS)
        self.fn(*self.static)
        solver.TOEPLITZ_COUNTS.update(built)


@pytest.fixture
def stand_in(monkeypatch):
    """Graphed solves on the CPU (a graph is captured only on the card):
    a capture runs its function once, as a capture runs its Python (so the
    counters see it and take it back), then restores the solve's static
    tensors, as a capture launches nothing; a replay runs it again.  The
    solver's counts start at zero, the device counts apart."""

    def capture(fn, static):
        graph = fn.__self__
        kept = [t for t in (*graph.state, graph.mult) if t is not None]
        saved = [t.clone() for t in kept]
        out = fn(*static)
        for t, s in zip(kept, saved):
            t.copy_(s)
        return _Rerun(fn, static), out

    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(solver, "_live", {})
    solver.reset_cgnr_counts()
    solver.reset_cgnr_graph_counts()
    solver.reset_cgnr_prologue_counts()
    solver.reset_toeplitz_counts()


@pytest.mark.parametrize("toeplitz", [False, True])
def test_graphed_solve_replays_its_prologue(stand_in, toeplitz):
    """A geometry's first solve runs its prologue eagerly, then captures it;
    each later solve replays it (with ``toeplitz`` the multiplier, then the
    right side and the state from a static copy of a strided data window)
    and gives a first solve's bits on the same input.  `TOEPLITZ_COUNTS`
    still counts one multiplier a solve, and the prologue's counts reset
    in place."""
    _, cfg, _, ang, _ = _problem(24, 16)
    g = torch.Generator().manual_seed(26)
    series = torch.randn((2, 20, 48), generator=g, dtype=torch.complex64)
    windows = [series[:, 2 * z: 2 * z + 16] for z in range(2)]
    angles = [_t(ang), _t(ang) + 0.05]
    assert not windows[1].is_contiguous()
    graph = solver._CGGraph(windows[0], angles[0], cfg, None, toeplitz, 1e-6)
    first = graph.solve(windows[0], angles[0], 4)
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 0, "eager": 1}
    assert solver.CGNR_GRAPH_COUNTS["captured"] == 1
    replayed = [graph.solve(windows[1], angles[1], 4), graph.solve(windows[0], angles[0], 4)]
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 2, "eager": 1}
    assert solver.TOEPLITZ_COUNTS == {"nufft": 3 if toeplitz else 0, "exact": 0}
    fresh = solver._CGGraph(windows[1], angles[1], cfg, None, toeplitz, 1e-6)
    want = fresh.solve(windows[1], angles[1], 4)
    assert not torch.equal(want, first)
    assert torch.equal(replayed[0], want) and torch.equal(replayed[1], first)
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 2, "eager": 2}
    assert solver.CGNR_GRAPH_COUNTS["captured"] == 2
    assert solver.TOEPLITZ_COUNTS == {"nufft": 4 if toeplitz else 0, "exact": 0}
    counts = solver.CGNR_PROLOGUE_COUNTS
    solver.reset_cgnr_prologue_counts()
    assert solver.CGNR_PROLOGUE_COUNTS is counts and counts == {"replayed": 0, "eager": 0}


@pytest.mark.parametrize("rtol,iterations", [(1e-6, 10), (0.05, 3)])
def test_each_rtol_has_its_graph_and_stops_where_the_eager_loop_stops(stand_in, rtol,
                                                                      iterations):
    """``rtol`` is in the graphs' key, so a threshold captured for one rtol
    is never replayed for another; a replayed solve stops where the eager
    loop stops, bit for bit, after as many iterations."""
    _, cfg, _, ang, data = _problem(24, 16)
    d, a = _t(data), _t(ang)
    keys = {solver._graph_key(d, a, cfg, False, None, r) for r in (1e-6, 0.05, rtol)}
    assert len(keys) == 2
    graph = solver._CGGraph(d, a, cfg, None, False, rtol)
    graph.solve(d, a + 0.05, 10)  # the geometry's first solve captures
    solver.reset_cgnr_counts()
    got = graph.solve(d, a, 10)
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 1, "eager": 1}
    assert solver.cgnr_counts() == {"solves": 0, "iterations": iterations}
    want = solver.cgnr_radial2d(d, a, cfg, niter=10, rtol=rtol, operators="pair")
    assert solver.cgnr_counts() == {"solves": 1, "iterations": 2 * iterations}
    assert torch.equal(got, want)
