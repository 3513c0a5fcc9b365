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

from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.ops import degrid_cuda, grid_cuda
from tron_tpu_torch.ops.degrid import degrid_radial2d
from tron_tpu_torch.ops.grid import grid_radial2d, grid_radial2d_planes_plain
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
                      incremental=mode == "incremental")
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
    cfg = ReconConfig(koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.25)
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
    cfg = ReconConfig(koosh=True, golden_angle=True, data_undersamp=0.5)
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
    cfg = ReconConfig(koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.25)
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
                      incremental="incremental" in mode)
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
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=21, adjoint=True)
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

