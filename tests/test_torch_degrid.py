"""The port's forward degridding (tron_tpu_torch.ops.degrid, .degrid_cuda)
and forward / exact-lattice NUFFT vs the JAX package on the CPU.

The plain gather and the dense form are held to JAX's twins; the kernel
wrapper's CPU route to the Pallas kernel `_degrid_kernel` itself, run in
interpret mode as the JAX package's own tests run it.  Inputs are numpy
arrays from seeds, handed to both packages.  The CUDA kernel has no CPU
mode: its tests are in tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu import nufft as jnufft
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.ops import degrid as jdegrid
from tron_tpu.ops import degrid_pallas as jdegrid_pallas
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch import nufft
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.ops import degrid, degrid_cuda, grid_cuda

torch.set_num_threads(1)

KW = 2.0
BETA = kb_beta(KW, 2.0)


def _grid(seed, C, n) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, n, n)) + 1j * rng.standard_normal((C, n, n))).astype(
        np.complex64
    )


def _angles(npe, skip):
    return np.asarray(jangles(npe, "golden", skip))


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def test_lattice_radii_match_jax_formula():
    for nro, n in [(128, 128), (96, 72), (75, 64)]:
        want = np.asarray((jnp.arange(nro, dtype=jnp.float32) / nro - 0.5) * n)
        np.testing.assert_array_equal(degrid.lattice_radii(nro, n).numpy(), want)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("n,nro,kw", [(64, 64, 2.0), (48, 64, 2.0), (64, 63, 1.5), (32, 32, 3.0)])
def test_plain_gather_matches_jax(wrap, n, nro, kw):
    g = _grid(n + nro, 2, n)
    ang = _angles(9, 19990)
    beta = kb_beta(kw, 2.0)
    want = np.asarray(
        jdegrid.degrid_radial2d(
            jnp.asarray(g), jnp.asarray(ang), nro, kw, beta, backend="gather", wrap=wrap
        )
    )
    got = degrid.degrid_radial2d(_t(g), _t(ang), nro, kw, beta, wrap=wrap)
    assert got.dtype == torch.complex64 and got.shape == (2, 9, nro)
    assert nrmse(got.numpy(), want) <= 1e-5
    one = degrid.degrid_radial2d(_t(g[0]), _t(ang), nro, kw, beta, wrap=wrap)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def _kb_unit(kw, beta) -> float:
    """The KB window is not normalised (the deapodisation divides it out): a
    weight product reaches (I0(beta) / 2kw)^2, 8e21 at kw 6.5.  Grids scaled
    by its inverse keep the samples, and their float32 norms, near 1."""
    return (2 * kw / float(np.i0(beta))) ** 2


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("kw", [4.0, 6.5])
def test_plain_gather_wide_kernels_match_jax(wrap, kw):
    """Kernel widths of 9 to 14 neighbours per axis (the card's wide
    degridding instantiation; its plain version here) vs JAX's gather, at
    the tolerance of tests/test_degrid_pallas.py:44."""
    n, nro = 64, 64
    beta = kb_beta(kw, 2.0)
    g = _grid(int(10 * kw), 3, n) * np.complex64(_kb_unit(kw, beta))
    ang = _angles(10, 19990)
    assert int(2 * kw) + 1 in (9, 14) and int(2 * kw) + 1 <= degrid_cuda.MAX_OFF
    want = np.asarray(
        jdegrid.degrid_radial2d(
            jnp.asarray(g), jnp.asarray(ang), nro, kw, beta, backend="gather", wrap=wrap
        )
    )
    got = degrid_cuda.degrid_radial2d(_t(g), _t(ang), nro, kw, beta, wrap=wrap)
    assert np.isfinite(want).all() and 0.01 < np.abs(want).max() < 1e4
    assert got.shape == (3, 10, nro) and nrmse(got.numpy(), want) <= 2e-4


@pytest.mark.parametrize("kw", [4.0, 6.5])
def test_plain_pair_dot_test_wide_kernels(kw):
    """The dot test of test_plain_pair_dot_test at the wide kernel widths."""
    nro = nxos = 64
    npe = 7
    beta = kb_beta(kw, 2.0)
    x = _t(_grid(8, 1, nxos)) * _kb_unit(kw, beta)
    y = _t(_grid(9, 1, nro)[:, :npe])
    y[..., 0] = 0  # readout 0 is never gridded
    ang = _t(_angles(npe, 2))
    Ax = degrid_cuda.degrid_radial2d(x, ang, nro, kw, beta, wrap=False)
    AHy = grid_cuda.grid_radial2d(y, ang, nxos, kw, beta) * (nxos * npe)
    assert 0.01 < float(Ax.abs().max()) < 1e4
    lhs = complex(torch.vdot(y.reshape(-1), Ax.reshape(-1)))
    rhs = complex(torch.vdot(AHy.reshape(-1), x.reshape(-1)))
    assert abs(lhs - rhs) / abs(rhs) < 1e-4


@pytest.mark.parametrize("wrap", [True, False])
def test_dense_matches_jax(wrap):
    n, nro = 48, 64
    g = _grid(7, 2, n)
    ang = _angles(11, 3)
    want = np.asarray(
        jdegrid._degrid_dense(jnp.asarray(g), jnp.asarray(ang), nro, KW, BETA, pe_chunk=4, wrap=wrap)
    )
    got = degrid._degrid_dense(_t(g), _t(ang), nro, KW, BETA, pe_chunk=4, wrap=wrap)
    assert got.shape == (2, 11, nro)
    assert nrmse(got.numpy(), want) <= 1e-5
    # the dense form is the gather's contract
    gather = degrid.degrid_radial2d(_t(g), _t(ang), nro, KW, BETA, wrap=wrap)
    assert nrmse(got.numpy(), gather.numpy()) <= 1e-5


def _interior_mask(nro, kw=2):
    """tests/test_degrid_pallas.py:21-23: the Pallas kernel clips where the
    gather wraps, so only readouts clear of the grid edge compare."""
    ro = np.arange(nro)
    return (np.abs(ro - nro // 2) <= nro // 2 - kw - 2) & (ro != 0)


@pytest.mark.parametrize(
    "matmul_dtype,tol", [("float32", 2e-4), ("bf16x3", 2e-4), ("bf16x2", 3e-4)]
)
def test_wrapper_matches_pallas_degrid_kernel(matmul_dtype, tol):
    """The wrapper's CPU route vs `_degrid_kernel` in interpret mode at the
    JAX test's size and bound (tests/test_degrid_pallas.py:26-44), at the
    same precision class; bf16x2 at the bf16 classes' bound of
    tests/test_torch_precision.py (the KB weights' bf16 flip noise)."""
    C, npe, n = 2, 12, 256
    g = _grid(21, C, n)
    ang = _angles(npe, 7)
    want = np.asarray(
        jdegrid_pallas.degrid_radial2d_pallas(
            jnp.asarray(g), jnp.asarray(ang), n, KW, BETA, pe_chunk=4,
            matmul_dtype=matmul_dtype, interpret=True,
        )
    )
    launches = degrid_cuda.LAUNCHES
    got = degrid_cuda.degrid_radial2d(_t(g), _t(ang), n, KW, BETA, matmul_dtype=matmul_dtype)
    assert degrid_cuda.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.complex64 and got.shape == (C, npe, n)
    m = _interior_mask(n)
    assert nrmse(got.numpy()[..., m], want[..., m]) < tol
    clip = degrid_cuda.degrid_radial2d(
        _t(g), _t(ang), n, KW, BETA, matmul_dtype=matmul_dtype, wrap=False
    )
    # under wrap bf16x2 and bf16x3 take JAX's wrap-edge readouts at float32,
    # readout n - 4 of the interior among them (`tron_tpu/nufft.py:221-224`);
    # every other interior readout is the class's under wrap and clip alike
    edge = np.zeros(n, dtype=bool)
    edge[degrid.wrap_edge_readouts(n, n, KW).numpy()] = degrid.fp32_wrap_edges(matmul_dtype, True)
    assert nrmse(clip.numpy()[..., m & ~edge], got.numpy()[..., m & ~edge]) == 0.0
    f32 = degrid_cuda.degrid_radial2d(_t(g), _t(ang), n, KW, BETA)
    assert torch.equal(got[..., m & edge], f32[..., m & edge])


def _pallas_wrap(g, ang, nro, matmul_dtype, kw=KW, beta=BETA):
    """JAX's forward degridding under wrap at a class: `_degrid_kernel` in
    interpret mode, then its wrap-edge patch at precision="highest"
    (`tron_tpu/nufft.py:283-302`; the classes bf16x2 to float32)."""
    kg, ja = jnp.asarray(g), jnp.asarray(ang)
    clip = jdegrid_pallas.degrid_radial2d_pallas(
        kg, ja, nro, kw, beta, pe_chunk=4, matmul_dtype=matmul_dtype, interpret=True
    )
    return np.asarray(
        jnufft._patch_degrid_wrap_edges(clip, kg, ja, nro, kw, beta, precision="highest")
    )


@pytest.mark.parametrize("matmul_dtype,tol", [("bf16x2", 3e-4), ("bf16x3", 2e-4)])
def test_wrapper_matches_pallas_degrid_with_wrap_edge_patch(matmul_dtype, tol):
    """The wrapper's CPU route under wrap vs JAX's Pallas degrid plus its
    wrap-edge patch, at the geometry of the masked test above: the edge
    readouts within JAX's own fp32 patch error of float32, the whole output,
    unmasked, within the bound that test holds the interior to."""
    C, npe, n = 2, 12, 256
    g = _grid(21, C, n)
    ang = _angles(npe, 7)
    want = _pallas_wrap(g, ang, n, matmul_dtype)
    got = degrid_cuda.degrid_radial2d(_t(g), _t(ang), n, KW, BETA, matmul_dtype=matmul_dtype)
    idx = degrid.wrap_edge_readouts(n, n, KW).numpy()
    assert got.shape == (C, npe, n) and len(idx) == 8
    assert nrmse(got.numpy()[..., idx], want[..., idx]) <= 1e-5
    assert nrmse(got.numpy(), want) < tol


@pytest.mark.parametrize("ratio", [1, 2])
@pytest.mark.parametrize("kw", [2.0, 3.0, 4.0])
def test_wrap_edge_readouts_are_jax_index_set(kw, ratio):
    """`wrap_edge_readouts` is the set JAX's patch overwrites: the readouts
    that `_patch_degrid_wrap_edges` makes finite in an all-NaN output."""
    n = 64
    nro = ratio * n
    npe = 3
    nan = jnp.full((1, npe, nro), jnp.nan, dtype=jnp.complex64)
    patched = np.asarray(jnufft._patch_degrid_wrap_edges(
        nan, jnp.ones((1, n, n), jnp.complex64), jnp.asarray(_angles(npe, 0)), nro, kw,
        kb_beta(kw, 2.0), precision="highest",
    ))
    want = np.flatnonzero(np.isfinite(patched).all(axis=(0, 1)))
    got = degrid.wrap_edge_readouts(nro, n, kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(np.delete(patched, want, axis=-1)).all()


@pytest.mark.parametrize(
    "matmul_dtype,wrap",
    [("bfloat16", True), ("float32", True), ("bfloat16", False), ("bf16x2", False),
     ("bf16x3", False), ("float32", False), ("bf16x2", True), ("bf16x3", True)],
)
def test_wrap_edge_rule_touches_only_the_edges_at_bf16x2_and_bf16x3(matmul_dtype, wrap):
    """The class computed with no patch (``readouts`` = every readout) is
    the output bit for bit at bfloat16, float32 and in clip mode; at bf16x2
    and bf16x3 under wrap every readout outside `wrap_edge_readouts` is, and
    those are the float32 output's bit for bit."""
    C, npe, n = 2, 12, 256
    g = _t(_grid(5, C, n))
    ang = _t(_angles(npe, 3))
    got = degrid_cuda.degrid_radial2d(g, ang, n, KW, BETA, matmul_dtype=matmul_dtype, wrap=wrap)
    bare = degrid.degrid_radial2d(g, ang, n, KW, BETA, wrap=wrap, matmul_dtype=matmul_dtype,
                                  readouts=torch.arange(n))
    idx = degrid.wrap_edge_readouts(n, n, KW)
    patched = degrid.fp32_wrap_edges(matmul_dtype, wrap)
    assert patched == (wrap and matmul_dtype in ("bf16x2", "bf16x3"))
    if not patched:
        assert torch.equal(got, bare)
        return
    keep = torch.ones(n, dtype=torch.bool)
    keep[idx] = False
    assert torch.equal(got[..., keep], bare[..., keep])
    assert not torch.equal(got[..., idx], bare[..., idx])
    f32 = degrid.degrid_radial2d(g, ang, n, KW, BETA, wrap=True)
    assert torch.equal(got[..., idx], f32[..., idx])


@pytest.mark.parametrize(
    "matmul_dtype,wrap,tol", [("bf16x2", True, 3e-4), ("bf16x3", True, 2e-4),
                              ("bf16x3", False, 2e-4)],
)
def test_nufft_forward_at_class_matches_jax_pallas_forward(monkeypatch, matmul_dtype, wrap, tol):
    """The forward of a 128^2 image (nxos 256) at a bf16 class, routed as
    on the card (the wrappers get cfg.matmul_dtype), vs JAX's forward
    through its Pallas backend, its kernel in interpret mode: pad, deapod,
    FFT, `_degrid_kernel` and under wrap the fp32 edge patch
    (`tron_tpu/nufft.py:283-302`).  The whole output, unmasked."""
    n, npe = 128, 12
    jcfg, cfg = _cfgs(2.0, backend="pallas", matmul_dtype=matmul_dtype)
    cfg = dataclasses.replace(cfg, backend="auto")
    img = _grid(13, 2, n)
    ang = _angles(npe, 40)
    monkeypatch.setattr(jdegrid_pallas, "degrid_radial2d_pallas", functools.partial(
        jdegrid_pallas.degrid_radial2d_pallas, pe_chunk=4, interpret=True))
    want = np.asarray(jnufft.nufft_forward(jnp.asarray(img), jnp.asarray(ang), jcfg, wrap=wrap))
    monkeypatch.setattr(nufft, "kernel_class", lambda c, device: c.matmul_dtype)
    got = nufft.nufft_forward(_t(img), _t(ang), cfg, wrap=wrap).numpy()
    assert got.shape == want.shape == (2, npe, 2 * n)
    assert nrmse(got, want) < tol
    if wrap:
        idx = degrid.wrap_edge_readouts(2 * n, 2 * n, KW).numpy()
        assert nrmse(got[..., idx], want[..., idx]) <= 1e-5


@pytest.mark.parametrize("n,nro", [(128, 128), (256, 255), (64, 64)])
@pytest.mark.parametrize("matmul_dtype", ["bfloat16", "bf16x2"])
def test_wrapper_takes_the_dense_fallback_class(n, nro, matmul_dtype):
    """A grid that does not tile into two 128-pixel tiles, or an odd nro,
    is degridded in fp32 whatever the class: JAX sends it to its dense
    degridder (`degrid_pallas.py:319-325`), clip mode."""
    C, npe = 2, 12
    g = _grid(n + nro, C, n)
    ang = _angles(npe, 7)
    want = np.asarray(
        jdegrid_pallas.degrid_radial2d_pallas(
            jnp.asarray(g), jnp.asarray(ang), nro, KW, BETA, pe_chunk=4,
            matmul_dtype=matmul_dtype, interpret=True,
        )
    )
    got = degrid_cuda.degrid_radial2d(_t(g), _t(ang), nro, KW, BETA,
                                      matmul_dtype=matmul_dtype, wrap=False)
    assert got.shape == (C, npe, nro)
    assert nrmse(got.numpy(), want) <= 1e-5
    f32 = degrid_cuda.degrid_radial2d(_t(g), _t(ang), nro, KW, BETA, wrap=False)
    assert torch.equal(got, f32)
    assert degrid_cuda.degridder_class(n, nro, matmul_dtype) == "float32"


def test_degridder_class_follows_jax_dispatch():
    for n, nro, want in [(256, 256, "bf16x3"), (512, 512, "bf16x3"), (384, 512, "bf16x3"),
                         (256, 255, "float32"), (128, 128, "float32"), (320, 320, "float32"),
                         (64, 64, "float32")]:
        assert degrid_cuda.degridder_class(n, nro, "bf16x3") == want, (n, nro)
    with pytest.raises(ValueError, match="matmul_dtype"):
        degrid_cuda.degridder_class(256, 256, "fp8")


@pytest.mark.parametrize("wrap", [True, False])
def test_nufft_forward_bfloat16_small_image_matches_jax(monkeypatch, wrap):
    """The forward of a 64^2 image (nxos 128) at bfloat16, routed as on the
    card (the wrappers get cfg.matmul_dtype), vs JAX's forward through its
    Pallas backend: JAX degrids that grid densely in fp32 and patches the
    wrap edges at XLA's default precision, fp32 on the CPU
    (`tron_tpu/nufft.py:283-301`); the port computes float32."""
    n, npe = 64, 10
    jcfg, cfg = _cfgs(2.0, backend="pallas", matmul_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, backend="auto")
    img = _grid(11, 2, n)
    ang = _angles(npe, 40)
    want = np.asarray(jnufft.nufft_forward(jnp.asarray(img), jnp.asarray(ang), jcfg, wrap=wrap))
    monkeypatch.setattr(nufft, "kernel_class", lambda c, device: c.matmul_dtype)
    got = nufft.nufft_forward(_t(img), _t(ang), cfg, wrap=wrap)
    assert got.shape == (2, npe, 2 * n)
    assert nrmse(got.numpy(), want) <= 1e-5
    f32 = nufft.nufft_forward(_t(img), _t(ang), dataclasses.replace(cfg, matmul_dtype="float32"),
                              wrap=wrap)
    assert torch.equal(got, f32)


def _cfgs(gridos, **kw):
    jcfg = JaxConfig(golden_angle=True, gridos=gridos, **kw)
    return jcfg, ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("gridos,wrap", [(2.0, True), (2.0, False), (1.5, True), (2.5, False)])
def test_nufft_forward_matches_jax(backend, gridos, wrap):
    n, npe = 32, 10
    jcfg, cfg = _cfgs(gridos)
    cfg = dataclasses.replace(cfg, backend=backend)
    img = _grid(3, 2, n)
    ang = _angles(npe, 40)
    want = np.asarray(
        jnufft.nufft_forward(jnp.asarray(img), jnp.asarray(ang), jcfg, nro=2 * n, wrap=wrap)
    )
    got = nufft.nufft_forward(_t(img), _t(ang), cfg, nro=2 * n, wrap=wrap)
    assert got.shape == (2, npe, 2 * n)
    assert nrmse(got.numpy(), want) <= 1e-5
    dflt = nufft.nufft_forward(_t(img), _t(ang), cfg)
    assert dflt.shape == (2, npe, int(n * gridos))


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("gridos", [1.5, 2.5])
def test_nufft_adjoint_exact_matches_jax(backend, gridos):
    nro, npe = 64, 12
    jcfg, cfg = _cfgs(gridos)
    cfg = dataclasses.replace(cfg, backend=backend)
    d = _grid(5, 2, nro)[:, :npe]                      # (2, npe, nro) samples
    ang = _angles(npe, 9)
    want = np.asarray(jnufft.nufft_adjoint_exact(jnp.asarray(d), jnp.asarray(ang), jcfg))
    got = nufft.nufft_adjoint_exact(_t(d), _t(ang), cfg)
    assert got.shape == (2, nro // 2, nro // 2)
    assert nrmse(got.numpy(), want) <= 1e-5
    # readout 0 is never gridded
    d0 = d.copy()
    d0[..., 0] = 1e3
    np.testing.assert_array_equal(nufft.nufft_adjoint_exact(_t(d0), _t(ang), cfg).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("gridos", [1.5, 2.0, 2.5])
def test_plain_pair_dot_test(gridos):
    """<y, A x> = <A^H y, x> for the plain clip-mode degrid and the plain
    gridder on the shared lattice (tests/test_grid_pallas.py:394-419),
    integer radii at gridos 2 as the CGNR pair takes them."""
    nro, npe = 64, 7
    nxos = int((nro // 2) * gridos)
    beta = kb_beta(KW, gridos)
    x = _t(_grid(8, 1, nxos))
    rng = np.random.default_rng(9)
    y = _t((rng.standard_normal((1, npe, nro)) + 1j * rng.standard_normal((1, npe, nro)))
           .astype(np.complex64))
    y[..., 0] = 0  # readout 0 is never gridded
    ang = _t(_angles(npe, 2))
    Ax = degrid_cuda.degrid_radial2d(x, ang, nro, KW, beta, wrap=False)
    if nro == nxos:
        AHy = grid_cuda.grid_radial2d(y, ang, nxos, KW, beta)
    else:
        AHy = grid_cuda.grid_radial2d_exact(y, ang, nxos, KW, beta)
    AHy = AHy * (nxos * npe)  # undo the gridder's reference 1/(nxos*npe) scale
    lhs = complex(torch.vdot(y.reshape(-1), Ax.reshape(-1)))
    rhs = complex(torch.vdot(AHy.reshape(-1), x.reshape(-1)))
    assert abs(lhs - rhs) / abs(rhs) < 1e-4


def test_wrappers_reject_what_the_kernels_do_not_take():
    g = torch.zeros((1, 16, 16), dtype=torch.complex64)
    ang = torch.zeros(4)
    with pytest.raises(ValueError, match="matmul_dtype"):
        degrid_cuda.degrid_radial2d(g, ang, 16, KW, BETA, matmul_dtype="fp8")
    with pytest.raises(ValueError, match="complex64"):
        degrid_cuda._check(g.to(torch.complex128), ang, 16, KW)
    with pytest.raises(ValueError, match="square"):
        degrid_cuda._check(torch.zeros((1, 16, 8), dtype=torch.complex64), ang, 16, KW)
    with pytest.raises(ValueError, match="angles"):
        degrid_cuda._check(g, ang.double(), 16, KW)
    degrid_cuda._check(g, ang, 16, 4.0)   # the wide instantiation's range
    degrid_cuda._check(g, ang, 16, 6.5)
    with pytest.raises(ValueError, match="kernwidth"):
        degrid_cuda._check(g, ang, 16, grid_cuda.MAX_KERNWIDTH)
    with pytest.raises(ValueError, match="nro"):
        degrid_cuda._check(g, ang, 0, KW)
    planes = torch.zeros((4, 16, 2))
    with pytest.raises(ValueError, match="nR >= 2"):
        grid_cuda._check_planes(torch.zeros((4, 1, 2)), ang, 16, exact=True)
    grid_cuda._check_planes(planes, ang, 99, exact=True)  # any row count


def test_kernel_backend_on_cpu_tensor_raises():
    _, cfg = _cfgs(2.0)
    img = _t(_grid(1, 1, 16))
    ang = _t(_angles(4, 0))
    launches = degrid_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        nufft.nufft_forward(img, ang, dataclasses.replace(cfg, backend="pallas"))
    with pytest.raises(ValueError, match="CUDA"):
        nufft.nufft_adjoint_exact(img, ang, dataclasses.replace(cfg, backend="pallas"))
    assert degrid_cuda.LAUNCHES == launches
