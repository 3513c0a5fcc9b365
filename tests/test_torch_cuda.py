"""The port's CUDA gridding and degridding kernels vs their plain torch
versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device: the kernel
has no CPU mode.  The file imports nothing of JAX or of tests/conftest.py,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tron_tpu_torch.config import KernelTuning
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.ops import degrid_cuda, grid_cuda
from tron_tpu_torch.ops.degrid import degrid_radial2d, lattice_radii, wrap_edge_readouts
from tron_tpu_torch.ops.grid import (
    grid_radial2d,
    grid_radial2d_planes_culled,
    grid_radial2d_planes_plain,
)
from tron_tpu_torch.ops.precision import MATMUL_DTYPES, bf16
from tron_tpu_torch.trajectory import spoke_angles

torch.set_num_threads(1)

KW = 2.0
BETA = kb_beta(KW, 2.0)
TOL = 1e-5  # NRMSE: the same fp32 terms summed in two orders


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    # the plain version is the fp32 oracle: no TF32 in its matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _nrmse(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "nxos,C,npe,skip",
    [(64, 1, 8, 5), (128, 2, 12, 5), (256, 2, 48, 9000), (512, 6, 204, 19000), (128, 10, 1500, 0)],
)
def test_kernel_matches_plain(dev, nxos, C, npe, skip):
    rng = np.random.default_rng(nxos + npe)
    planes = torch.from_numpy(rng.standard_normal((npe, nxos, 2 * C), dtype=np.float32)).to(dev)
    planes[: npe // 2] *= -1  # signed, as in an incremental delta
    ang = spoke_angles(npe, "golden", skip, device=dev)
    launches = grid_cuda.LAUNCHES
    got = grid_cuda.grid_radial2d_planes(planes, ang, nxos, KW, BETA)
    again = grid_cuda.grid_radial2d_planes(planes, ang, nxos, KW, BETA)
    want = grid_radial2d_planes_plain(planes, ang, nxos, KW, BETA)
    torch.cuda.synchronize()
    assert grid_cuda.LAUNCHES == launches + 2
    assert got.shape == (C, nxos, nxos) and got.dtype == torch.complex64
    assert _nrmse(got, want) <= TOL
    assert torch.equal(got, again)  # fixed summation order, no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("matmul_dtype", MATMUL_DTYPES)
@pytest.mark.parametrize("kernel", ["B1", "B5", "B4", "B2", "B3", "B3 kw 4"])
def test_kernel_matches_plain_at_each_class(dev, kernel, matmul_dtype):
    """Each kernel at each precision class vs its plain version at the same
    class on the card: the bf16 classes round the same operands (the weights
    bit for bit, kb.cuh), so only the fp32 sums' order differs; a bf16 class
    is applied (its error against float32 is the plain version's, within
    2x); repeats are bitwise."""
    rng = np.random.default_rng(17)
    ang = spoke_angles(48, "golden", 9000, device=dev)
    if kernel.startswith("B3"):
        kw = 4.0 if "kw 4" in kernel else KW
        beta = kb_beta(kw, 2.0)
        g = torch.from_numpy((rng.standard_normal((3, 256, 256)) + 1j * rng.standard_normal(
            (3, 256, 256))).astype(np.complex64)).to(dev) * _kb_unit(kw, beta)

        def kern(c):
            return degrid_cuda.degrid_radial2d(g, ang, 256, kw, beta, matmul_dtype=c, wrap=False)

        def plain(c):
            return degrid_radial2d(g, ang, 256, kw, beta, wrap=False, matmul_dtype=c)
    else:
        nxos = 128 if kernel == "B2" else 256
        planes = torch.from_numpy(rng.standard_normal((48, nxos, 6), dtype=np.float32)).to(dev)
        windowed = kernel != "B4"
        tuning = KernelTuning(batched=True) if kernel == "B5" else None

        def kern(c):
            return grid_cuda.grid_radial2d_planes(planes, ang, nxos, KW, BETA, matmul_dtype=c,
                                                  windowed=windowed, tuning=tuning)

        def plain(c):
            cls, rounded = grid_cuda.gridder_class(nxos, c, windowed)
            p = bf16(planes) if rounded else planes
            f = grid_radial2d_planes_plain if windowed else grid_radial2d_planes_culled
            return f(p, ang, nxos, KW, BETA, matmul_dtype=cls)
    got, again = kern(matmul_dtype), kern(matmul_dtype)
    want, ref32 = plain(matmul_dtype), plain("float32")
    torch.cuda.synchronize()
    assert _nrmse(got, want) <= TOL
    assert torch.equal(got, again)
    own = _nrmse(want, ref32)
    if matmul_dtype != "float32" and own > 0:  # float32: B4's plain sums atomically
        assert 0.5 * own <= _nrmse(got, ref32) <= 2 * own


@pytest.mark.gpu
@pytest.mark.parametrize("matmul_dtype", MATMUL_DTYPES)
@pytest.mark.parametrize("n,nro", [(128, 128), (256, 255)])
def test_degrid_dense_fallback_shapes_compute_float32(dev, n, nro, matmul_dtype):
    """B3 on a grid that does not tile, or at an odd nro, computes float32
    at every class, as JAX's dense fallback does (`degridder_class`); the
    forward of a 64^2 image at the card's default class is its float32 run."""
    from tron_tpu_torch import nufft
    from tron_tpu_torch.config import ReconConfig

    rng = np.random.default_rng(n + nro)
    g = _complex(rng, (2, n, n), dev)
    ang = spoke_angles(12, "golden", 7, device=dev)
    for wrap in (True, False):
        got = degrid_cuda.degrid_radial2d(g, ang, nro, KW, BETA, matmul_dtype=matmul_dtype,
                                          wrap=wrap)
        assert torch.equal(got, degrid_cuda.degrid_radial2d(g, ang, nro, KW, BETA, wrap=wrap))
        assert _nrmse(got, degrid_radial2d(g, ang, nro, KW, BETA, wrap=wrap)) <= TOL
    img = _complex(rng, (2, 64, 64), dev)
    cfg = ReconConfig(golden_angle=True, matmul_dtype=matmul_dtype)
    f32 = ReconConfig(golden_angle=True, matmul_dtype="float32")
    assert torch.equal(nufft.nufft_forward(img, ang, cfg), nufft.nufft_forward(img, ang, f32))


@pytest.mark.gpu
def test_complex_entry_matches_dense(dev):
    rng = np.random.default_rng(1)
    d = rng.standard_normal((2, 12, 128)) + 1j * rng.standard_normal((2, 12, 128))
    d = torch.from_numpy(d.astype(np.complex64)).to(dev)
    ang = spoke_angles(12, "golden", 5, device=dev)
    got = grid_cuda.grid_radial2d(d, ang, 128, KW, BETA)
    assert _nrmse(got, grid_radial2d(d, ang, 128, KW, BETA)) <= TOL


@pytest.mark.gpu
def test_wrapper_raises_on_bad_input(dev):
    planes = torch.zeros((4, 64, 3), device=dev)
    with pytest.raises(ValueError):
        grid_cuda.grid_radial2d_planes(planes, torch.zeros(4, device=dev), 64, KW, BETA)
    with pytest.raises(ValueError):
        grid_cuda.grid_radial2d_planes(
            torch.zeros((4, 64, 2), device=dev), torch.zeros(4), 64, KW, BETA
        )


def _complex(rng, shape, dev):
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.complex64)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize(
    "n,C,npe,nro",
    [(64, 1, 8, 64), (128, 2, 12, 128), (256, 2, 48, 256), (512, 6, 204, 512),
     (128, 10, 30, 128), (192, 2, 20, 256), (320, 2, 20, 256), (128, 2, 12, 127)],
)
def test_degrid_kernel_matches_plain(dev, wrap, n, C, npe, nro):
    rng = np.random.default_rng(n + C + nro)
    g = _complex(rng, (C, n, n), dev)
    ang = spoke_angles(npe, "golden", 19000, device=dev)
    launches = degrid_cuda.LAUNCHES
    got = degrid_cuda.degrid_radial2d(g, ang, nro, KW, BETA, wrap=wrap)
    again = degrid_cuda.degrid_radial2d(g, ang, nro, KW, BETA, wrap=wrap)
    want = degrid_radial2d(g, ang, nro, KW, BETA, wrap=wrap)
    torch.cuda.synchronize()
    assert degrid_cuda.LAUNCHES == launches + 2
    assert got.shape == (C, npe, nro) and got.dtype == torch.complex64
    assert _nrmse(got, want) <= TOL
    assert torch.equal(got, again)  # one owner per sample, no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("matmul_dtype", ["bf16x2", "bf16x3"])
@pytest.mark.parametrize("n,C,npe", [(512, 6, 204), (256, 6, 48)])
def test_degrid_wrap_edges_are_the_float32_kernels(dev, n, C, npe, matmul_dtype):
    """Under wrap at bf16x2 and bf16x3 the wrapper makes two launches: the
    wrap-edge readouts (`wrap_edge_readouts`, JAX's patched set) are the
    float32 kernel's bit for bit, every other readout the class kernel's
    (its launch alone); the result holds against the plain version, which
    applies the same rule."""
    rng = np.random.default_rng(n + npe)
    g = _complex(rng, (C, n, n), dev)
    ang = spoke_angles(npe, "golden", 19000, device=dev)
    launches = degrid_cuda.LAUNCHES
    got = degrid_cuda.degrid_radial2d(g, ang, n, KW, BETA, matmul_dtype=matmul_dtype)
    assert degrid_cuda.LAUNCHES == launches + 2
    f32 = degrid_cuda.degrid_radial2d(g, ang, n, KW, BETA)
    cls = degrid_cuda._launch(degrid_cuda.to_grid_planes(g), torch.cos(ang), torch.sin(ang),
                              lattice_radii(n, n, dev), KW, BETA, True, matmul_dtype)
    want = degrid_radial2d(g, ang, n, KW, BETA, wrap=True, matmul_dtype=matmul_dtype)
    torch.cuda.synchronize()
    idx = wrap_edge_readouts(n, n, KW).to(dev)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[idx] = False
    assert got.shape == (C, npe, n) and len(idx) == 8
    assert torch.equal(got[..., idx], f32[..., idx])
    assert torch.equal(got[..., keep], cls[..., keep])
    assert not torch.equal(got[..., idx], cls[..., idx])
    assert _nrmse(got, want) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("gridos", [1.5, 2.0, 2.5])
def test_exact_lattice_matches_plain(dev, gridos):
    nro, npe = 256, 24
    nxos = int((nro // 2) * gridos)
    beta = kb_beta(KW, gridos)
    rng = np.random.default_rng(int(10 * gridos))
    d = _complex(rng, (2, npe, nro), dev)
    ang = spoke_angles(npe, "golden", 7, device=dev)
    got = grid_cuda.grid_radial2d_exact(d, ang, nxos, KW, beta)
    d0 = d.clone()
    d0[..., 0] = 0  # readout 0 is never gridded; the dense oracle would grid it
    want = grid_radial2d(d0, ang, nxos, KW, beta, raw_rows=True)
    assert _nrmse(got, want) <= TOL
    if gridos == 2.0:
        # the identity radius map: the row lattice equals the integer radii
        assert _nrmse(got, grid_cuda.grid_radial2d(d, ang, nxos, KW, beta)) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("gridos", [1.5, 2.0, 2.5])
def test_kernel_pair_dot_test(dev, gridos):
    """<y, A x> = <A^H y, x> for the clip-mode degridding kernel and the
    gridding kernel (tests/test_grid_pallas.py:394-419)."""
    nro, npe = 256, 9
    nxos = int((nro // 2) * gridos)
    beta = kb_beta(KW, gridos)
    rng = np.random.default_rng(3)
    x = _complex(rng, (1, nxos, nxos), dev)
    y = _complex(rng, (1, npe, nro), dev)
    y[..., 0] = 0
    ang = spoke_angles(npe, "golden", 2, device=dev)
    Ax = degrid_cuda.degrid_radial2d(x, ang, nro, KW, beta, wrap=False)
    if nro == nxos:
        AHy = grid_cuda.grid_radial2d(y, ang, nxos, KW, beta)
    else:
        AHy = grid_cuda.grid_radial2d_exact(y, ang, nxos, KW, beta)
    AHy = AHy * (nxos * npe)
    lhs = complex(torch.vdot(y.reshape(-1), Ax.reshape(-1)))
    rhs = complex(torch.vdot(AHy.reshape(-1), x.reshape(-1)))
    assert abs(lhs - rhs) / abs(rhs) < 1e-4


@pytest.mark.gpu
def test_degrid_wrapper_raises_on_bad_input(dev):
    g = torch.zeros((1, 64, 64), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        degrid_cuda.degrid_radial2d(g, torch.zeros(4), 64, KW, BETA)  # angles on the CPU
    with pytest.raises(ValueError):
        degrid_cuda.degrid_radial2d(g.to(torch.complex128), torch.zeros(4, device=dev), 64,
                                    KW, BETA)
    with pytest.raises(ValueError):
        degrid_cuda.degrid_radial2d(g, torch.zeros(4, device=dev), 64, 7.0, BETA)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("kw", [1.5, 2.0, 3.0])
@pytest.mark.parametrize(
    "nxos,C,npe,scheme",
    [(64, 1, 8, "golden"), (100, 3, 17, "golden"), (384, 3, 30, "linear_half"),
     (512, 6, 204, "golden"), (128, 10, 1500, "golden"), (8, 1, 5, "golden"),
     (36, 2, 11, "golden"), (40, 2, 12, "golden")],
)
def test_seg_and_batched_kernels_equal_loop_kernel(dev, exact, kw, nxos, C, npe, scheme):
    """The segmented kernel (windowed=False, B4) sums the default tile
    kernel's (B1) nonzero fp32 terms in its order, regrouped only at work
    items: within 1e-6 NRMSE of B1.  The tensor-core kernel (tuning.batched,
    B5) contracts every row as 3xTF32 products: within 1e-5 of the plain
    version, as B1 and B4 are of theirs.  No atomics: each repeat run gives
    the same bits.  Partial tiles (nxos 100), split tiles and long spoke
    lists (1500), two channel blocks (C 10), an odd coil count (3), signed
    data, both lattices; segment lengths that are not multiples of 8 (nxos
    8, 36, 40: 3-20 rows, odd lattices of 27 and 75 rows), down to more
    than 32 segments per stage (seg 3)."""
    from tron_tpu_torch.config import KernelTuning
    from tron_tpu_torch.ops.degrid import lattice_radii
    from tron_tpu_torch.ops.grid import grid_radial2d_planes_culled

    beta = kb_beta(kw, 2.0)
    rng = np.random.default_rng(nxos + C + int(10 * kw))
    nR = nxos * 3 // 4 if exact else nxos
    planes = torch.from_numpy(rng.standard_normal((npe, nR, 2 * C), dtype=np.float32)).to(dev)
    planes[: npe // 2] *= -1
    ang = spoke_angles(npe, scheme, 19000 if scheme == "golden" else 0, device=dev)
    rad = lattice_radii(nR, nxos, dev) if exact else None
    bt = KernelTuning(batched=True)
    counts = dict(grid_cuda.LAUNCH_COUNTS)
    tile = grid_cuda._launch(planes, ang, nxos, kw, beta, rad, True, None)
    seg = grid_cuda._launch(planes, ang, nxos, kw, beta, rad, False, None)
    seg2 = grid_cuda._launch(planes, ang, nxos, kw, beta, rad, False, None)
    batched = grid_cuda._launch(planes, ang, nxos, kw, beta, rad, True, bt)
    batched2 = grid_cuda._launch(planes, ang, nxos, kw, beta, rad, True, bt)
    torch.cuda.synchronize()
    assert torch.equal(seg, seg2) and torch.equal(batched, batched2)
    assert _nrmse(seg, tile) <= 1e-6
    assert [grid_cuda.LAUNCH_COUNTS[k] - counts[k] for k in grid_cuda.KERNELS] == [1, 2, 2]
    culled = grid_radial2d_planes_culled(planes, ang, nxos, kw, beta, rad=rad)
    # the planes gridder at the lattice's row radii is the culled one (equal
    # to 1e-6, tests/test_torch_seg_tiles.py); on integer radii the plain
    # planes gridder
    plain = culled if exact else grid_radial2d_planes_plain(planes, ang, nxos, kw, beta)
    assert _nrmse(seg, culled) <= TOL
    assert _nrmse(batched, plain) <= TOL
    assert _nrmse(tile, plain) <= TOL


@pytest.mark.gpu
def test_tile_kernel_raises_beyond_its_weight_windows(dev):
    """The tile kernel's weight windows, floor(2*kw) + 3 pixels per axis,
    fit 16 lanes each below kernwidth 7; from there the wrapper raises."""
    planes = torch.zeros((4, 64, 2), device=dev)
    ang = spoke_angles(4, "golden", 0, device=dev)
    grid_cuda.grid_radial2d_planes(planes, ang, 64, 6.9, kb_beta(6.9, 2.0))
    with pytest.raises(ValueError, match="kernwidth"):
        grid_cuda.grid_radial2d_planes(planes, ang, 64, grid_cuda.MAX_KERNWIDTH,
                                       kb_beta(grid_cuda.MAX_KERNWIDTH, 2.0))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["batched", "seg"])
def test_batched_and_seg_wrappers_raise_beyond_their_weight_windows(dev, kernel):
    """B5 and B4 read B1's weight table: they take kernwidth < 7 as B1 does
    (the per-pixel row slots and their limit are gone), and raise beyond."""
    from tron_tpu_torch.config import KernelTuning

    opts = {"tuning": KernelTuning(batched=True)} if kernel == "batched" else {"windowed": False}
    planes = torch.zeros((4, 64, 2), device=dev)
    ang = spoke_angles(4, "golden", 0, device=dev)
    grid_cuda.grid_radial2d_planes(planes, ang, 64, 5.0, kb_beta(5.0, 2.0), **opts)
    with pytest.raises(ValueError, match="kernwidth"):
        grid_cuda.grid_radial2d_planes(planes, ang, 64, grid_cuda.MAX_KERNWIDTH,
                                       kb_beta(grid_cuda.MAX_KERNWIDTH, 2.0), **opts)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["direct", "incremental", "half", "batched"])
def test_streaming_matches_in_memory(dev, tmp_path, monkeypatch, mode):
    """The streamed recon on the card (pinned buffers, copy streams, reader
    thread) vs the in-memory recon: the same frames through the same
    kernels, so the same bits (incremental: each block restarts its sum)."""
    import dataclasses

    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.io import ra_write
    from tron_tpu_torch.recon import recon_radial2d, recon_radial2d_streaming

    rng = np.random.default_rng(5)
    shape = (4, 1, 256, 102 + 40 * 21, 1)
    d = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ra_write(d, tmp_path / "d.ra")
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=21, adjoint=True,
                      incremental=mode == "incremental", matmul_dtype="float32")
    if mode == "batched":
        monkeypatch.setenv("TRON_BATCHED", "1")
    grid_cuda.reset_launches()
    got = recon_radial2d_streaming(tmp_path / "d.ra", cfg, batch_frames=16, device=dev,
                                   half=mode == "half")
    want = recon_radial2d(d[..., 0], dataclasses.replace(cfg, incremental=False), device=dev)
    kernel = "grid_radial2d_batched" if mode == "batched" else "grid_radial2d"
    assert grid_cuda.LAUNCH_COUNTS[kernel] > 0 and grid_cuda.LAUNCHES == grid_cuda.LAUNCH_COUNTS[kernel]
    if mode == "half":
        assert torch.equal(torch.from_numpy(got[0]), torch.from_numpy(want.real.astype(np.float16)))
    elif mode == "incremental":
        assert _nrmse(torch.from_numpy(got), torch.from_numpy(want)) <= 1e-5
    else:
        assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))


def _kb_unit(kw, beta) -> float:
    """The KB window is not normalised (the deapodisation divides it out): a
    weight product reaches (I0(beta) / 2kw)^2, 8e21 at kw 6.5.  Grids scaled
    by its inverse keep the samples, and their float32 norms, near 1."""
    return (2 * kw / float(np.i0(beta))) ** 2


@pytest.mark.gpu
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("kw", [3.9, 4.0, 6.5])
@pytest.mark.parametrize("n,C,npe,nro", [(64, 1, 8, 64), (256, 6, 48, 256), (128, 10, 30, 127)])
def test_degrid_wide_kernel_matches_plain(dev, wrap, kw, n, C, npe, nro):
    """Kernel widths on both sides of the narrow instantiation's 8
    neighbours per axis: 3.9 is its last width, 4 and 6.5 (9 and 14
    neighbours) run the wide one."""
    beta = kb_beta(kw, 2.0)
    rng = np.random.default_rng(n + C + int(10 * kw))
    g = _complex(rng, (C, n, n), dev) * _kb_unit(kw, beta)
    ang = spoke_angles(npe, "golden", 19000, device=dev)
    got = degrid_cuda.degrid_radial2d(g, ang, nro, kw, beta, wrap=wrap)
    again = degrid_cuda.degrid_radial2d(g, ang, nro, kw, beta, wrap=wrap)
    want = degrid_radial2d(g, ang, nro, kw, beta, wrap=wrap)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all() and 0.01 < float(want.abs().max()) < 1e4
    assert _nrmse(got, want) <= TOL
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [4.0, 6.5])
def test_kernel_pair_dot_test_wide(dev, kw):
    nro = nxos = 256
    npe = 9
    beta = kb_beta(kw, 2.0)
    rng = np.random.default_rng(3)
    x = _complex(rng, (2, nxos, nxos), dev) * _kb_unit(kw, beta)
    y = _complex(rng, (2, npe, nro), dev)
    y[..., 0] = 0
    ang = spoke_angles(npe, "golden", 2, device=dev)
    Ax = degrid_cuda.degrid_radial2d(x, ang, nro, kw, beta, wrap=False)
    AHy = grid_cuda.grid_radial2d(y, ang, nxos, kw, beta) * (nxos * npe)
    assert 0.01 < float(Ax.abs().max()) < 1e4
    lhs = complex(torch.vdot(y.reshape(-1), Ax.reshape(-1)))
    rhs = complex(torch.vdot(AHy.reshape(-1), x.reshape(-1)))
    assert abs(lhs - rhs) / abs(rhs) < 1e-4


def _host_complex(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.gpu
@pytest.mark.parametrize("half", [False, True])
def test_koosh_adjoint_on_the_card(dev, half):
    """-3 adjoint, 6 coils, 2 repetitions, 12 kz slices (two blocks of 8
    with a realigned tail): the kernel once per slice, repetition and
    in-plane frame, vs the plain gridder on the card."""
    import dataclasses

    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.recon import recon_radial2d

    d = _host_complex(1, (6, 2, 256, 200, 12))
    cfg = ReconConfig(koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.25,
                      matmul_dtype="float32")
    grid_cuda.reset_launches()
    got = recon_radial2d(d, cfg, half_readback=half, device=dev)
    assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == (8 + 8) * 2 * 3  # the tail block overlaps
    want = recon_radial2d(d, dataclasses.replace(cfg, backend="jnp"), device=dev)
    assert got.shape == want.shape == (36, 2, 128, 128)
    assert _nrmse(torch.from_numpy(got), torch.from_numpy(want)) <= (2.0**-11 if half else TOL)


@pytest.mark.gpu
def test_koosh_forward_on_the_card(dev):
    """-3 forward with nt 2 and 6 coils: 24 real channels per degridding
    call, two channel blocks of the kernel."""
    import dataclasses

    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.recon import recon_radial2d

    imgs = _host_complex(2, (6, 2, 64, 64, 5))
    cfg = ReconConfig(koosh=True, golden_angle=True, data_undersamp=0.5, matmul_dtype="float32")
    degrid_cuda.reset_launches()
    got = recon_radial2d(imgs, cfg, device=dev)
    assert degrid_cuda.LAUNCHES == 5
    want = recon_radial2d(imgs, dataclasses.replace(cfg, backend="jnp"), device=dev)
    assert got.shape == want.shape == (5, 6, 2, 64, 128)
    assert _nrmse(torch.from_numpy(got), torch.from_numpy(want)) <= TOL


@pytest.mark.gpu
def test_koosh_streaming_on_the_card(dev, tmp_path):
    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.io import ra_write
    from tron_tpu_torch.recon import recon_koosh_streaming, recon_radial2d

    d = _host_complex(3, (4, 1, 128, 7 * 32 + 5, 10))
    ra_write(d, tmp_path / "d.ra")
    cfg = ReconConfig(koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.25,
                      matmul_dtype="float32")
    mem = recon_radial2d(d, cfg, device=dev)
    got = recon_koosh_streaming(tmp_path / "d.ra", cfg, batch_frames=3, device=dev)
    assert got.shape == mem.shape == (70, 1, 64, 64)
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(mem))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["walsh", "walsh-incremental", "compress"])
def test_walsh_and_compress_on_the_card(dev, mode):
    """Walsh and in-memory compression are plain torch on the data's device:
    the card's images vs the same recon on the CPU (Walsh: 1e-4, the power
    iteration amplifies the two devices' rounding; compression by
    root-sum-of-squares, a virtual coil being fixed up to a phase)."""
    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.recon import recon_radial2d

    # three sources of falling strength mixed into 6 coils, plus noise: the
    # top-3 coil subspace is well separated from the rest
    base = _host_complex(4, (3, 1, 128, 51 + 3 * 21)) * np.array([1, 0.5, 0.25]).reshape(3, 1, 1, 1)
    mix = np.linalg.qr(_host_complex(5, (6, 3)))[0]
    d = np.einsum("ck,ktrp->ctrp", mix, base) + 0.01 * _host_complex(6, (6, 1, 128, 51 + 3 * 21))
    d = d.astype(np.complex64)
    cfg = ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21,
                      coil_combine="walsh" if "walsh" in mode else "sos",
                      coil_compress=3 if mode == "compress" else 0,
                      incremental="incremental" in mode, matmul_dtype="float32")
    grid_cuda.reset_launches()
    got = recon_radial2d(d, cfg, device=dev)
    assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == 4
    want = recon_radial2d(d, cfg, device="cpu")
    assert got.shape == want.shape == (4, 1, 64, 64)
    assert _nrmse(torch.from_numpy(np.abs(got)), torch.from_numpy(np.abs(want))) <= 1e-4


# -- the sharded recon on the card ---------------------------------------------


@pytest.mark.gpu
def test_two_ranks_share_the_card_and_launch_the_kernels(dev):
    """tools.dryrun_multichip on the card: two ranks on one device run over
    gloo on CUDA tensors, pass the four sharded checks against the unsharded
    port, and each launched the CUDA kernels (a CUDA rank never computes on
    the CPU)."""
    from tron_tpu_torch.tools import dryrun_multichip

    res = dryrun_multichip.dryrun_multichip(2, timeout=300.0)
    assert len(res) == 2
    for r in res:
        assert len(r.value) == 4 and r.imported == ()
        assert r.device.startswith("cuda")
        assert r.backend == ("gloo" if torch.cuda.device_count() < 2 else "nccl")
        assert r.launches["grid_radial2d"] > 0 and r.launches["degrid_radial2d"] > 0


@pytest.mark.gpu
def test_sharded_scheduler_at_world_1_is_the_unsharded_one(dev):
    """A 1 x 1 mesh with no process group: recon_frames_sharded gives
    recon_frames' bits with recon_frames' launches, for each coil combine."""
    import dataclasses

    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.parallel import make_mesh, recon_frames_sharded
    from tron_tpu_torch.recon import recon_frames

    rng = np.random.default_rng(7)
    d = torch.from_numpy(
        (rng.standard_normal((3, 93, 128)) + 1j * rng.standard_normal((3, 93, 128))).astype(
            np.complex64)).to(dev)
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=21, adjoint=True,
                      matmul_dtype="float32")
    work, slide, nz = cfg.frame_geometry(128, 93)
    mesh = make_mesh(1, 1, device=dev)
    for combine in ("sos", "walsh", "none"):
        c = dataclasses.replace(cfg, coil_combine=combine)
        n0 = grid_cuda.LAUNCHES
        want = recon_frames(d, c, work, slide, nz, 5)
        n1 = grid_cuda.LAUNCHES
        got = recon_frames_sharded(d, c, mesh, work, slide, nz, 5)
        assert grid_cuda.LAUNCHES - n1 == n1 - n0 == nz
        assert torch.equal(got, want)



# -- the frame loop's CUDA graph -------------------------------------------------


def _fresh_graphs():
    from tron_tpu_torch import recon

    recon._frame_graphs.entries.clear()
    recon.reset_frame_graph_counts()
    grid_cuda.reset_launches()
    return recon


def _eager_chain(data, cfg, work, slide, nz, skip0):
    """The hoisted path frame by frame, eagerly, each frame's angles from
    its own `spoke_angles` call."""
    from tron_tpu_torch.nufft import nufft_adjoint_planes, sdc_weights
    from tron_tpu_torch.recon import _combine

    nro = data.shape[-1]
    w = sdc_weights(cfg, nro, work, data.device).to(data.dtype)
    planes = grid_cuda.to_sample_planes(data * w, int((nro // 2) * cfg.gridos))
    scheme = cfg.scheme_for("adjoint")
    return torch.stack([
        _combine(nufft_adjoint_planes(
            planes[z * slide : z * slide + work],
            spoke_angles(work, scheme, cfg.skip_angles + skip0 + z * slide, device=data.device),
            cfg), cfg)
        for z in range(nz)
    ])


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["sos", "walsh", "none"])
@pytest.mark.parametrize("nc,nro,nz,matmul_dtype", [(3, 128, 6, "float32"),
                                                    (6, 512, 8, "bfloat16")])
def test_frame_graph_replays_the_eager_chain(dev, combine, nc, nro, nz, matmul_dtype):
    """recon_frames on the card captures one frame's chain once per
    geometry and replays it for every later frame: bitwise the eager
    chain, at a small geometry and at whole-body shape (-u 0.4 -d 21, 6
    coils, 512 readouts, bfloat16).  A second call captures nothing and
    replays nz - 1 frames more; the counter of the gridding kernel grows by
    nz a call, a launch that reached the card per frame."""
    from tron_tpu_torch.config import ReconConfig

    cfg = ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21,
                      coil_combine=combine, matmul_dtype=matmul_dtype)
    work = int(nro * 0.4)
    d = torch.from_numpy(_host_complex(nro + nz, (nc, work + (nz - 1) * 21, nro))).to(dev)
    assert cfg.frame_geometry(nro, d.shape[1]) == (work, 21, nz)
    recon = _fresh_graphs()
    got = recon.recon_frames(d, cfg, work, 21, nz, 19000)
    assert recon.FRAME_GRAPH_COUNTS == {"captured": 1, "replayed": nz - 1, "eager": 1}
    assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == grid_cuda.LAUNCHES == nz
    again = recon.recon_frames(d, cfg, work, 21, nz, 19000)
    assert recon.FRAME_GRAPH_COUNTS == {"captured": 1, "replayed": 2 * (nz - 1), "eager": 2}
    assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == grid_cuda.LAUNCHES == 2 * nz
    want = _eager_chain(d, cfg, work, 21, nz, 19000)
    assert got.shape == want.shape and torch.isfinite(torch.view_as_real(want)).all()
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.gpu
def test_frame_graph_one_per_geometry(dev):
    """Another frame length is another geometry: a second graph; the
    first is still cached and replays without a capture."""
    from tron_tpu_torch.config import ReconConfig

    d = torch.from_numpy(_host_complex(8, (2, 200, 128))).to(dev)
    recon = _fresh_graphs()
    for u, captured in ((0.4, 1), (0.5, 2), (0.4, 2)):
        cfg = ReconConfig(adjoint=True, golden_angle=True, data_undersamp=u, prof_slide=21,
                          matmul_dtype="float32")
        work, slide, nz = cfg.frame_geometry(128, 200)
        got = recon.recon_frames(d, cfg, work, slide, nz)
        assert recon.FRAME_GRAPH_COUNTS["captured"] == captured
        assert torch.equal(got, _eager_chain(d, cfg, work, slide, nz, 0))
    assert len(recon._frame_graphs.entries) == 2


def _eager_frames(monkeypatch, recon):
    """Every frame of the direct scheduler run by its eager call."""
    orig = recon._map_frames
    monkeypatch.setattr(recon, "_map_frames",
                        lambda one, nz, then=None, sink=None: orig(one, nz, sink=sink))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["stream", "koosh", "koosh-stream"])
def test_frame_graph_in_the_streamed_and_koosh_recons(dev, tmp_path, monkeypatch, mode):
    """The streamed recon (per block, its loader and reader threads copying
    during the capture) and the -3 recon (per slice) replay the graph and
    give the bits of the same recon with every frame run eagerly."""
    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.io import ra_write
    from tron_tpu_torch.recon import (
        recon_koosh_streaming,
        recon_radial2d,
        recon_radial2d_streaming,
    )

    koosh = mode.startswith("koosh")
    shape = (4, 1, 128, 7 * 32 + 5, 6) if koosh else (4, 1, 256, 102 + 40 * 21, 1)
    d = _host_complex(9, shape)
    cfg = ReconConfig(adjoint=True, golden_angle=True, koosh=koosh, matmul_dtype="float32",
                      data_undersamp=0.25 if koosh else 0.4, prof_slide=0 if koosh else 21)
    ra_write(d, tmp_path / "d.ra")
    recon = _fresh_graphs()
    if mode == "stream":
        got = recon_radial2d_streaming(tmp_path / "d.ra", cfg, batch_frames=16, device=dev)
    elif mode == "koosh-stream":
        got = recon_koosh_streaming(tmp_path / "d.ra", cfg, batch_frames=3, device=dev)
    else:
        got = recon_radial2d(d, cfg, device=dev)
    counts = dict(recon.FRAME_GRAPH_COUNTS)
    assert counts["captured"] == 1 and counts["replayed"] > counts["eager"] > 0
    _eager_frames(monkeypatch, recon)
    want = recon_radial2d(d if koosh else d[..., 0], cfg, device=dev)
    assert recon.FRAME_GRAPH_COUNTS["replayed"] == counts["replayed"]
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["incremental", "cgnr", "forward", "sharded-coils"])
def test_frame_graph_bypassed(dev, monkeypatch, path):
    """The incremental scheduler, CGNR, the forward operator and a sharded
    coil axis (a collective inside the combine; a stand-in here) run no
    graph."""
    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.parallel.distributed import MeshAxis

    cfg = ReconConfig(adjoint=path != "forward", golden_angle=True, data_undersamp=0.4,
                      prof_slide=21, incremental=path == "incremental",
                      niter=2 if path == "cgnr" else 0, matmul_dtype="float32")
    recon = _fresh_graphs()
    if path == "forward":
        recon.recon_radial2d(_host_complex(10, (2, 1, 64, 64, 2)), cfg, device=dev)
    elif path == "sharded-coils":
        monkeypatch.setattr(recon, "psum", lambda x, axis: x)
        d = torch.from_numpy(_host_complex(11, (2, 93, 128))).to(dev)
        recon.recon_frames(d, cfg, 51, 21, 3, coil_axis=MeshAxis("coil", 2, 0, None))
    else:
        recon.recon_radial2d(_host_complex(12, (2, 1, 128, 93)), cfg, device=dev)
    torch.cuda.synchronize()
    assert recon.FRAME_GRAPH_COUNTS["captured"] == recon.FRAME_GRAPH_COUNTS["replayed"] == 0
    assert recon.FRAME_GRAPH_COUNTS["eager"] == {"cgnr": 3, "sharded-coils": 3}.get(path, 0)


@pytest.mark.gpu
def test_frame_graph_under_the_profiler(dev):
    """A capture and its replays inside a profiler's session: the trace
    holds the capture's span, one graph launch and one B1 contraction a
    replayed frame (the benchmark's traced run checks the gridding
    counter against those kernels), and the bits of the eager chain."""
    from tron_tpu_torch.config import ReconConfig

    cfg = ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21,
                      matmul_dtype="float32")
    d = torch.from_numpy(_host_complex(13, (3, 51 + 5 * 21, 128))).to(dev)
    recon = _fresh_graphs()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = recon.recon_frames(d, cfg, 51, 21, 6)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type() != cuda]
    kernels = [e.name() for e in events if e.device_type() == cuda]
    assert host.count("tron.frame_graph") == 1 and host.count("cudaGraphLaunch") == 5
    contract = sum("grid_tile_contract_kernel" in n for n in kernels)
    assert contract == grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == 6
    assert torch.equal(got, _eager_chain(d, cfg, 51, 21, 6, 0))


# -- the CGNR iteration's CUDA graph ---------------------------------------------


def _fresh_cgnr():
    from tron_tpu_torch import solver

    solver._cg_graphs.entries.clear()
    solver.reset_cgnr_counts()
    solver.reset_cgnr_graph_counts()
    solver.reset_cgnr_prologue_counts()
    solver.reset_toeplitz_counts()
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    return solver


def _cgnr_case(dev, shape, seed, matmul_dtype="float32", **kw):
    """(cfg, data (nc, npe, nro) on the card, two frames' golden angles)."""
    from tron_tpu_torch.config import ReconConfig

    npe = shape[1]
    cfg = ReconConfig(golden_angle=True, matmul_dtype=matmul_dtype, **kw)
    d = torch.from_numpy(_host_complex(seed, shape)).to(dev)
    return cfg, d, [spoke_angles(npe, "golden", 19000 + 21 * z, device=dev) for z in (0, 1)]


def _eager_cgnr(solver, d, ang, cfg, **kw):
    """The eager loop on the card: a coil axis of one rank sums nothing, so
    its solve is the unsharded one's arithmetic with a host stop test."""
    from tron_tpu_torch.parallel.distributed import MeshAxis

    return solver.cgnr_radial2d(d, ang, cfg, reduce_axes=(MeshAxis("coil"),), **kw)


def _counters():
    return grid_cuda.LAUNCH_COUNTS["grid_radial2d"], degrid_cuda.LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("operators,shape,matmul_dtype,backend", [
    ("pair", (3, 51, 128), "float32", "auto"),
    ("toeplitz", (3, 51, 128), "float32", "auto"),
    ("pair", (3, 51, 128), "float32", "jnp"),
    ("pair", (6, 204, 512), "bfloat16", "auto"),
    ("toeplitz", (6, 204, 512), "bfloat16", "auto"),
])
def test_cgnr_graph_is_the_eager_loop(dev, operators, shape, matmul_dtype, backend):
    """A solve on the card captures one CG step once per geometry and
    replays it niter times: bitwise the eager loop, for two frames' angles
    through one graph, at a small shape and at whole-body widths (6 coils,
    204 spokes, 512 readouts, bfloat16), with the kernel pair, the Toeplitz
    normal operator and the plain operators (backend "jnp").  The first
    solve runs its prologue eagerly and captures it; the later ones replay
    it (`CGNR_PROLOGUE_COUNTS`) and capture nothing; in each the gridding
    and degridding counters grow as the eager solve's do (the first runs
    its first iteration eagerly, then captures, launching nothing more),
    and the Toeplitz operator counts one multiplier a solve."""
    solver = _fresh_cgnr()
    cfg, d, (a0, a1) = _cgnr_case(dev, shape, 30, matmul_dtype, backend=backend)
    got0 = solver.cgnr_radial2d(d, a0, cfg, niter=10, operators=operators)
    assert solver.CGNR_GRAPH_COUNTS == {"captured": 1, "replayed": 1, "eager": 0}
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 0, "eager": 1}
    first = _counters()
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    got1 = solver.cgnr_radial2d(d, a1, cfg, niter=10, operators=operators)
    assert solver.CGNR_GRAPH_COUNTS == {"captured": 1, "replayed": 2, "eager": 0}
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 1, "eager": 1}
    graphed = _counters()
    again0 = solver.cgnr_radial2d(d, a0, cfg, niter=10, operators=operators)
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 2, "eager": 1}
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    want1 = _eager_cgnr(solver, d, a1, cfg, niter=10, operators=operators)
    assert _counters() == graphed == first
    want0 = _eager_cgnr(solver, d, a0, cfg, niter=10, operators=operators)
    assert solver.CGNR_GRAPH_COUNTS == {"captured": 1, "replayed": 3, "eager": 2}
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 2, "eager": 3}
    assert solver.cgnr_counts() == {"solves": 5, "iterations": 50}
    assert solver.TOEPLITZ_COUNTS["nufft"] == (5 if operators == "toeplitz" else 0)
    assert torch.isfinite(torch.view_as_real(want0)).all() and not torch.equal(want0, want1)
    assert torch.equal(got0, want0) and torch.equal(got1, want1) and torch.equal(again0, want0)
    if backend == "auto":
        kernels = (11, 10) if operators == "pair" else (2, 0)  # + the multiplier's B1
        assert graphed == kernels


@pytest.mark.gpu
def test_toeplitz_graph_off_gridos_2_is_the_eager_loop(dev):
    """At gridos 1.5 the graphed Toeplitz solve captures the exact DTFT
    multiplier and the exact-lattice right side: a replayed prologue gives
    the eager loop's bits and counts one "exact" multiplier a solve."""
    solver = _fresh_cgnr()
    cfg, d, (a0, a1) = _cgnr_case(dev, (3, 51, 128), 36, gridos=1.5)
    got = [solver.cgnr_radial2d(d, a, cfg, niter=5, operators="toeplitz") for a in (a0, a1)]
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 1, "eager": 1}
    assert solver.TOEPLITZ_COUNTS == {"nufft": 0, "exact": 2}
    for a, x in zip((a0, a1), got):
        assert torch.equal(x, _eager_cgnr(solver, d, a, cfg, niter=5, operators="toeplitz"))
    assert solver.TOEPLITZ_COUNTS == {"nufft": 0, "exact": 4}


@pytest.mark.gpu
def test_cgnr_graph_stops_where_the_eager_loop_stops(dev):
    """With an rtol that the residual passes after k < niter iterations the
    graphed solve is bitwise the eager early stop (the later replays change
    no bit) and each adds k to cgnr_counts()["iterations"], its prologue
    replayed or not.  Another rtol on the same geometry is another graph
    (the captured threshold bakes rtol in), which stops where the eager
    loop stops for it; the first rtol's graph still stops at k."""
    solver = _fresh_cgnr()
    cfg, d, (a0, _) = _cgnr_case(dev, (3, 51, 128), 31)
    nc, npe, nro = d.shape
    w = solver._weights(cfg, nro, npe, dev).to(d.dtype)
    AHW, normal = solver._operators(a0, cfg, nro, (nc, nro // 2, nro // 2), w, "pair")
    b = AHW(d)
    rs = solver._inner(b, b)
    bb, hist = float(rs), []
    x, r, p, never = torch.zeros_like(b), b, b.clone(), torch.zeros_like(rs)
    for _ in range(10):
        solver._cg_step(x, r, p, rs, never, normal, solver._inner)
        hist.append(float(rs))
    rtols = {}
    for k in (4, 6):
        assert hist[k - 1] < 0.9 * hist[k - 2]
        rtols[k] = ((hist[k - 1] * hist[k - 2]) ** 0.5 / bb) ** 0.5
    k, rtol = 4, rtols[4]
    want = _eager_cgnr(solver, d, a0, cfg, niter=10, rtol=rtol)
    assert solver.cgnr_counts()["iterations"] == k
    got = solver.cgnr_radial2d(d, a0, cfg, niter=10, rtol=rtol)
    assert solver.cgnr_counts() == {"solves": 2, "iterations": 2 * k}
    assert solver.CGNR_GRAPH_COUNTS == {"captured": 1, "replayed": 1, "eager": 1}
    assert torch.equal(got, want)
    assert torch.equal(got, _eager_cgnr(solver, d, a0, cfg, niter=k))
    solver.reset_cgnr_counts()
    for k, rtol in ((6, rtols[6]), (6, rtols[6]), (4, rtols[4])):
        got = solver.cgnr_radial2d(d, a0, cfg, niter=10, rtol=rtol)
        assert solver.cgnr_counts()["iterations"] == k
        solver.reset_cgnr_counts()
        assert torch.equal(got, _eager_cgnr(solver, d, a0, cfg, niter=10, rtol=rtol))
        assert torch.equal(got, _eager_cgnr(solver, d, a0, cfg, niter=k))
        solver.reset_cgnr_counts()
    assert solver.CGNR_GRAPH_COUNTS["captured"] == 2
    assert solver.CGNR_PROLOGUE_COUNTS["replayed"] == 2


@pytest.mark.gpu
def test_cgnr_graph_one_per_geometry(dev):
    """Another spoke count is another geometry: a second graph; the first
    stays cached and replays without a capture."""
    solver = _fresh_cgnr()
    for npe, captured in ((51, 1), (60, 2), (51, 2)):
        cfg, d, (a0, _) = _cgnr_case(dev, (2, npe, 128), 32)
        got = solver.cgnr_radial2d(d, a0, cfg, niter=3)
        assert solver.CGNR_GRAPH_COUNTS["captured"] == captured
        assert torch.equal(got, _eager_cgnr(solver, d, a0, cfg, niter=3))
    assert len(solver._cg_graphs.entries) == 2


def _one_graph_launch_each(host, spans, count=None):
    """Each of the host's ``spans`` (``count`` of them, if given) holds one
    graph launch and no kernel launch."""
    launch = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
    assert count is None or len(spans) == count
    for s, t in spans:
        inside = [n for u, _, n in host if s <= u < t]
        assert inside.count("cudaGraphLaunch") == 1
        assert not any(n in launch for n in inside)


@pytest.mark.gpu
def test_cgnr_graph_under_the_profiler(dev):
    """Each `tron.cgnr_iter` of a graphed solve holds one graph launch and
    no other launch, and so does its replayed right side `tron.cgnr_rhs`;
    the B1 and B3 kernels in the trace are as many as the counters say,
    and the solve's bits are the eager loop's."""
    solver = _fresh_cgnr()
    cfg, d, (a0, a1) = _cgnr_case(dev, (3, 51, 128), 33)
    solver.cgnr_radial2d(d, a0, cfg, niter=5)
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = solver.cgnr_radial2d(d, a1, cfg, niter=5)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
            if e.device_type() != cuda]
    kernels = [e.name() for e in events if e.device_type() == cuda]
    iters = [(s, t) for s, t, n in host if n == "tron.cgnr_iter"]
    assert len(iters) == 5
    _one_graph_launch_each(host, iters)
    _one_graph_launch_each(host, [(s, t) for s, t, n in host if n == "tron.cgnr_rhs"], 1)
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 1, "eager": 1}
    assert sum("grid_tile_contract_kernel" in n for n in kernels) == _counters()[0] == 6
    assert sum("degrid_radial2d_kernel" in n for n in kernels) == _counters()[1] == 5
    assert torch.equal(got, _eager_cgnr(solver, d, a1, cfg, niter=5))


@pytest.mark.gpu
def test_toeplitz_graph_builds_its_multiplier_inside_the_solve(dev):
    """A graphed Toeplitz solve under the profiler opens one
    `tron.toeplitz_psf`, inside its `tron.cgnr` and before its right side,
    and builds one gridded multiplier a solve (`TOEPLITZ_COUNTS`), a
    replayed one included; a replayed solve's `tron.toeplitz_psf` and
    `tron.cgnr_rhs` each hold one graph launch and no kernel launch; its
    bits are the eager loop's."""
    solver = _fresh_cgnr()
    cfg, d, (a0, a1) = _cgnr_case(dev, (3, 51, 128), 35)
    solver.cgnr_radial2d(d, a0, cfg, niter=5, operators="toeplitz")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = solver.cgnr_radial2d(d, a1, cfg, niter=5, operators="toeplitz")
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events() if e.device_type() != cuda]
    by = {k: [(s, t) for s, t, n in host if n == k]
          for k in ("tron.toeplitz_psf", "tron.cgnr", "tron.cgnr_rhs")}
    assert [len(v) for v in by.values()] == [1, 1, 1]
    (ps, pe), (cs, ce), (rs, _) = (v[0] for v in by.values())
    assert cs <= ps and pe <= rs and pe <= ce
    _one_graph_launch_each(host, by["tron.toeplitz_psf"] + by["tron.cgnr_rhs"])
    assert solver.CGNR_GRAPH_COUNTS == {"captured": 1, "replayed": 2, "eager": 0}
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 1, "eager": 1}
    assert solver.TOEPLITZ_COUNTS == {"nufft": 2, "exact": 0}
    assert torch.equal(got, _eager_cgnr(solver, d, a1, cfg, niter=5, operators="toeplitz"))
    assert solver.TOEPLITZ_COUNTS == {"nufft": 3, "exact": 0}


# the host's waits in a graphed Toeplitz frame: `spoke_angles`' three scalar
# uploads (the skip, PHI and 2 pi), each a pageable copy the host waits on
FRAME_SYNCS = 3


@pytest.mark.gpu
def test_graphed_toeplitz_frame_waits_only_in_its_angles(dev):
    """A whole-body Toeplitz frame after the first (its solve replayed from
    the geometry's graphs) under torch's sync debug mode: every
    synchronising call torch warns of is made inside the frame's
    `tron.angles`, and there are FRAME_SYNCS of them."""
    import contextlib
    import warnings

    from tron_tpu_torch import recon

    solver = _fresh_cgnr()
    cfg, d, _ = _cgnr_case(dev, (6, 204, 512), 37, "bfloat16", niter=10, toeplitz=True)
    recon.reconstruct_frame(d, 19000, cfg)
    torch.cuda.synchronize()
    open_spans, syncs = [], []

    @contextlib.contextmanager
    def tracked(name):
        open_spans.append(name)
        try:
            yield
        finally:
            open_spans.pop()

    def show(message, *_):
        if str(message).startswith("called a synchronizing CUDA operation"):
            syncs.append(tuple(open_spans))

    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        for module in (recon, solver):
            mp.setattr(module, "span", tracked)
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            recon.reconstruct_frame(d, 19021, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert solver.CGNR_PROLOGUE_COUNTS == {"replayed": 1, "eager": 1}
    assert all("tron.angles" in names for names in syncs), syncs
    assert len(syncs) == FRAME_SYNCS, syncs


@pytest.mark.gpu
def test_sharded_cgnr_captures_nothing(dev):
    """A coil-sharded and a spoke-sharded solve (axes of one rank here) keep
    the eager loop, and give the graphed solve's bits."""
    from tron_tpu_torch.parallel.distributed import MeshAxis

    solver = _fresh_cgnr()
    cfg, d, (a0, _) = _cgnr_case(dev, (3, 51, 128), 34)
    npe = d.shape[1]
    coil = solver.cgnr_radial2d(d, a0, cfg, niter=4, reduce_axes=(MeshAxis("coil"),))
    spoke = solver.cgnr_radial2d(d, a0, cfg, niter=4, spoke_axis=MeshAxis("spoke"),
                                 npe_total=npe, sample_mask=torch.ones(npe, device=dev))
    assert solver.CGNR_GRAPH_COUNTS == {"captured": 0, "replayed": 0, "eager": 2}
    assert not solver._cg_graphs.entries
    got = solver.cgnr_radial2d(d, a0, cfg, niter=4)
    assert solver.CGNR_GRAPH_COUNTS["captured"] == 1
    assert torch.equal(coil, got) and torch.equal(spoke, got)


# -- the host driver's input path ----------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["C", "F"])
def test_series_relaid_on_the_card_is_the_host_relayout(dev, monkeypatch, order):
    """The whole-body series (6 coils, 512 readouts, 956 frames of 204
    spokes sliding by 21, bfloat16), uploaded in its own order (C, as the
    benchmark's input; F, as a .ra payload) and permuted on the card: its
    images are bitwise those of the former host transpose, it counts
    ``as_is``, and the peak of device memory rises by at most one input
    copy."""
    from tron_tpu_torch import recon
    from tron_tpu_torch.config import ReconConfig

    cfg = ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21)
    assert cfg.frame_geometry(512, 20271) == (204, 21, 956)
    g = torch.Generator(device=dev).manual_seed(2**33 + 24)
    x = torch.randn((6, 1, 512, 20271), generator=g, device=dev, dtype=torch.complex64)
    x = x.cpu().numpy()
    if order == "F":
        x = np.asfortranarray(x)

    def series():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out = recon.recon_radial2d(x, cfg, device=dev)
        return out, torch.cuda.max_memory_allocated(dev)

    recon.reset_upload_counts()
    got, peak = series()
    assert recon.UPLOAD_COUNTS == {"as_is": 1, "host_copy": 0}

    def host_relaid(host, dims):
        arr, device = host
        return torch.from_numpy(
            np.ascontiguousarray(np.transpose(arr, dims), dtype=np.complex64)).to(device)

    monkeypatch.setattr(recon, "_upload", lambda arr, device: (arr, device))
    monkeypatch.setattr(recon, "_relaid", host_relaid)
    want, want_peak = series()
    assert got.shape == want.shape == (956, 1, 256, 256)
    np.testing.assert_array_equal(got, want)
    assert peak <= want_peak + x.nbytes, (peak, want_peak, x.nbytes)


# -- the telescoping scheduler at whole-body widths ----------------------------


@pytest.mark.gpu
def test_incremental_series_on_the_card_against_the_reference(dev):
    """`recon_radial2d --incremental` host to host at whole-body widths (6
    coils, 512 readouts, frames of 204 spokes sliding by 21, bfloat16) over
    32 frames: every frame within the benchmark cell's limit of the plain
    reference, which grids each window from scratch; one seeded frame and
    31 telescoped; B1 launched once a frame; under a profiler 31
    ``tron.incremental_step`` spans and one B1 contraction a frame."""
    import json
    from pathlib import Path

    from benchmark.reference import incremental as reference
    from tron_tpu_torch import recon
    from tron_tpu_torch.config import ReconConfig

    nz = 32
    settings = {"adjoint": True, "golden_angle": True, "data_undersamp": 0.4,
                "prof_slide": 21, "gridos": 2.0, "kernwidth": 2.0, "skip_angles": 0,
                "incremental": True}
    cfg = ReconConfig(**settings, matmul_dtype="bfloat16")
    x = _host_complex(27, (6, 1, 512, 204 + 21 * (nz - 1)))
    assert cfg.frame_geometry(512, x.shape[-1]) == (204, 21, nz)
    limits = Path(__file__).resolve().parents[1] / "benchmark" / "limits"
    limit = json.loads((limits / "whole_body_incremental.incremental.json").read_text())

    recon.reset_incremental_counts()
    grid_cuda.reset_launches()
    got = recon.recon_radial2d(x, cfg, device=dev)[:, 0]
    assert recon.INCREMENTAL_COUNTS == {"seeded": 1, "telescoped": nz - 1, "direct": 0}
    assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == nz

    want = reference.Series(x, settings, dev).frames(list(range(nz)))
    g = torch.from_numpy(got).to(dev)
    err = (torch.linalg.vector_norm(g - want, dim=(1, 2))
           / torch.linalg.vector_norm(want, dim=(1, 2)))
    assert float(err.max()) <= limit["frame_rel_err"]["limit"], err

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        again = recon.recon_radial2d(x, cfg, device=dev)[:, 0]
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type() != cuda]
    kernels = [e.name() for e in events if e.device_type() == cuda]
    assert host.count("tron.incremental_step") == nz - 1
    assert sum("grid_tile_contract_kernel" in n for n in kernels) == nz
    assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == 2 * nz
    assert recon.INCREMENTAL_COUNTS == {"seeded": 2, "telescoped": 2 * (nz - 1), "direct": 0}
    np.testing.assert_array_equal(again, got)


@pytest.mark.gpu
def test_incremental_graph_replays_the_eager_scan(dev, monkeypatch):
    """`recon_radial2d --incremental` on the card at whole-body widths (6
    coils, 512 readouts, frames of 204 spokes sliding by 21, bfloat16) over
    48 frames: frames 0 and 1 run eagerly, one capture, then a replay of
    the step's graph a frame, bitwise the same scan sent down its eager
    branch.  A second series in the process captures nothing, reseeds the
    graph's carried grid and gives the first's bits; under a profiler it
    opens ``tron.incremental_step`` nz - 1 times, launches one graph a
    replayed frame and still one B1 contraction a frame.  A series of other
    samples, at another offset, shares the graph and is its own eager
    scan."""
    from tron_tpu_torch import recon
    from tron_tpu_torch.config import ReconConfig

    nz = 48
    cfg = ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21,
                      skip_angles=0, incremental=True, matmul_dtype="bfloat16")
    x = _host_complex(28, (6, 1, 512, 204 + 21 * (nz - 1)))
    y = _host_complex(29, x.shape)
    assert cfg.frame_geometry(512, x.shape[-1]) == (204, 21, nz)
    recon._incremental_graphs.entries.clear()
    recon.reset_incremental_graph_counts()
    grid_cuda.reset_launches()

    got = recon.recon_radial2d(x, cfg, device=dev)
    assert recon.INCREMENTAL_GRAPH_COUNTS == {"captured": 1, "replayed": nz - 2, "eager": 2}
    assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == nz

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        again = recon.recon_radial2d(x, cfg, device=dev)
    assert recon.INCREMENTAL_GRAPH_COUNTS == {"captured": 1, "replayed": 2 * (nz - 2),
                                              "eager": 4}
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type() != cuda]
    kernels = [e.name() for e in events if e.device_type() == cuda]
    assert host.count("tron.incremental_step") == nz - 1
    assert host.count("tron.incremental_graph") == 0
    assert host.count("cudaGraphLaunch") == nz - 2
    assert sum("grid_tile_contract_kernel" in n for n in kernels) == nz
    assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == 2 * nz

    d = torch.from_numpy(y[:, 0].transpose(0, 2, 1).copy()).to(dev)   # (nc, npe1, nro)
    other = recon.recon_frames_incremental(d, cfg, 204, 21, nz, 19000)
    assert recon.INCREMENTAL_GRAPH_COUNTS["captured"] == 1
    assert len(recon._incremental_graphs.entries) == 1

    monkeypatch.setattr(recon, "_graphed", lambda t, coil_axis: False)
    want = recon.recon_radial2d(x, cfg, device=dev)
    want_other = recon.recon_frames_incremental(d, cfg, 204, 21, nz, 19000)
    assert recon.INCREMENTAL_GRAPH_COUNTS["captured"] == 1
    assert np.isfinite(want).all() and torch.isfinite(torch.view_as_real(want_other)).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)
    assert torch.equal(other, want_other)


# -- the in-memory readback, block by block --------------------------------------


def _frame_outputs(monkeypatch, recon):
    """Keeps each device output the frame loops of `recon_radial2d` return."""
    outs = []
    for name in ("recon_frames", "recon_frames_incremental"):

        def kept(*args, _fn=getattr(recon, name), **kw):
            outs.append(_fn(*args, **kw))
            return outs[-1]

        monkeypatch.setattr(recon, name, kept)
    return outs


def _readback_cfg(mode):
    from tron_tpu_torch.config import ReconConfig

    kw = {"direct": {}, "incremental": {"incremental": True}, "cgnr": {"niter": 3}}[mode]
    return ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21,
                       matmul_dtype="bfloat16", **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("nz,nt", [(1, 1), (31, 1), (32, 1), (33, 1), (956, 1), (33, 2),
                                   (956, 2)])
@pytest.mark.parametrize("mode", ["direct", "incremental", "cgnr"])
def test_block_readback_is_the_device_output(dev, monkeypatch, mode, nz, nt):
    """Frames of 256 x 256 at whole-body widths (512 readouts, 204 spokes
    sliding by 21; 2 coils): 32 frames a block.  Through the direct
    scheduler, the telescoping scan and the CGNR pair, the host images of
    `recon_radial2d` are bitwise ``out.cpu().numpy()`` of the device
    outputs its frame loops returned, (nz, nt, n, n) C-ordered complex64;
    ``blocks`` counts ceil(nz / 32) a repetition and ``whole`` none."""
    from tron_tpu_torch import recon

    cfg = _readback_cfg(mode)
    x = _host_complex(nz + nt, (2, nt, 512, 204 + 21 * (nz - 1)))
    assert cfg.frame_geometry(512, x.shape[-1]) == (204, 21, nz)
    outs = _frame_outputs(monkeypatch, recon)
    recon.reset_readback_counts()
    got = recon.recon_radial2d(x, cfg, device=dev)
    assert recon.READBACK_COUNTS == {"blocks": nt * -(-nz // 32), "whole": 0}
    assert len(outs) == nt
    want = np.stack([o.cpu().numpy() for o in outs], axis=1)
    assert got.shape == want.shape == (nz, nt, 256, 256)
    assert got.dtype == np.complex64 and got.flags.c_contiguous and got.flags.writeable
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.gpu
def test_block_readback_returns_memory_of_its_own(dev):
    """Two successive series share no memory with each other or with any
    staging ring, and a write into the first leaves the second as it
    was."""
    from tron_tpu_torch import recon

    cfg = _readback_cfg("direct")
    x = _host_complex(5, (2, 1, 512, 204 + 21 * 99))
    first = recon.recon_radial2d(x, cfg, device=dev)
    second = recon.recon_radial2d(x, cfg, device=dev)
    kept = second.copy()
    assert not np.shares_memory(first, second)
    rings = [ring for free in recon._rings._free.values() for ring in free]
    assert rings
    for ring in rings:
        for buf in ring.pinned:
            assert not np.shares_memory(first, buf.numpy())
            assert not np.shares_memory(second, buf.numpy())
    first[...] = 7
    np.testing.assert_array_equal(second.view(np.uint32), kept.view(np.uint32))


@pytest.mark.gpu
def test_block_readbacks_in_four_threads(dev):
    """Four threads read back device outputs of their own at once, each on
    a compute stream of its own, three times each: every host result is
    bitwise its output, and the pool holds at most four rings of the key."""
    from tron_tpu_torch import recon

    nz, frame = 70, (256, 256)

    def series(seed):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            g = torch.Generator(device=dev).manual_seed(seed)
            out = torch.randn((nz,) + frame, generator=g, device=dev, dtype=torch.complex64)
            with recon._BlockReadback(nz, 1) as readback:
                sink = readback.sink(0)
                for z0, z1 in recon.readback_blocks(nz, out[0].numel() * 8):
                    sink(z0, z1, out)
                got = readback.result()
            return got, out.cpu().numpy()[:, None]

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=4) as pool:
        results = list(pool.map(series, range(12)))
    for got, want in results:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    key = (dev, (32,) + frame, torch.complex64)
    assert 1 <= len(recon._rings._free[key]) <= 4


@pytest.mark.gpu
def test_block_readback_under_the_profiler(dev):
    """A profiled direct series of 100 frames: one ``tron.readback`` span,
    on the calling thread; the images come back as four copies to pinned
    memory and none to pageable memory; every launch call is the calling
    thread's (the worker launches nothing)."""
    from tron_tpu_torch import recon

    cfg = _readback_cfg("direct")
    x = _host_complex(6, (2, 1, 512, 204 + 21 * 99))
    recon.recon_radial2d(x, cfg, device=dev)  # the graph, cuFFT's plan, the ring
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = recon.recon_radial2d(x, cfg, device=dev)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() != cuda]
    copies = [e.name() for e in events if e.device_type() == cuda and "DtoH" in e.name()]
    spans = [e for e in host if e.name() == "tron.readback"]
    frames = [e for e in host if e.name() == "tron.frame"]
    assert len(spans) == 1 and len(frames) == 100
    assert spans[0].start_thread_id() == frames[0].start_thread_id()
    assert len(copies) == 4 and all("Pinned" in n for n in copies), copies
    launches = [e for e in host if e.name() in ("cudaLaunchKernel", "cudaGraphLaunch")]
    assert got.shape == (100, 1, 256, 256)
    assert launches and {e.start_thread_id() for e in launches} == {spans[0].start_thread_id()}
