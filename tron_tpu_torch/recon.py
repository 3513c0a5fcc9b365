"""Reconstruction entry points (counterpart of `tron_tpu/recon.py`):
sliding-window frame scheduling over radial data (adjoint, plain or CGNR)
and the forward operator over image stacks.

Frames run in order in a Python loop, each written into one preallocated
output (the JAX package's ``lax.map`` / ``lax.scan``).  Features of the JAX
recon that are still to port raise ``NotImplementedError`` naming the
ROADMAP item that ports them; none falls back silently.
"""

from __future__ import annotations

import numpy as np
import torch

from tron_tpu_torch.config import AngleScheme, ReconConfig
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.nufft import (
    _adjoint_epilogue,
    _grid_backend,
    _kernel_backend,
    nufft_adjoint,
    nufft_adjoint_planes,
    nufft_forward,
    planes_path_ok,
    sdc_weights,
)
from tron_tpu_torch.ops import grid_cuda
from tron_tpu_torch.ops.coil import coil_combine_sos
from tron_tpu_torch.solver import cgnr_radial2d
from tron_tpu_torch.trajectory import spoke_angles


def _unported(feature: str, item: str):
    raise NotImplementedError(f"{feature} is not ported yet (ROADMAP {item})")


def _check_ported(cfg: ReconConfig) -> None:
    if cfg.coil_combine == "walsh":
        _unported("coil_combine='walsh'", "A16")


def _fetch_host(dev: torch.Tensor, half: bool) -> np.ndarray:
    """Device images -> host complex64.  ``half`` casts to float16 re/im
    planes on the device before the transfer (2x fewer bytes) and
    recombines on the host, value-identical to a later host-side --half
    store."""
    if half:
        re, im = torch.stack([dev.real, dev.imag]).to(torch.float16).cpu().numpy()
        return (re.astype(np.float32) + 1j * im.astype(np.float32)).astype(np.complex64)
    return dev.cpu().numpy()


def _combine(coilimg: torch.Tensor, cfg: ReconConfig) -> torch.Tensor:
    if cfg.coil_combine == "sos":
        return coil_combine_sos(coilimg, axis=0)
    if cfg.coil_combine == "none":
        return coilimg
    return _unported(f"coil_combine={cfg.coil_combine!r}", "A16")


def _map_frames(one, nz: int) -> torch.Tensor:
    """Frames 0..nz-1 in order, written into one preallocated output."""
    first = one(0)
    out = first.new_empty((nz,) + tuple(first.shape))
    out[0] = first
    for z in range(1, nz):
        out[z] = one(z)
    return out


def reconstruct_frame(data_window: torch.Tensor, skip, cfg: ReconConfig) -> torch.Tensor:
    """One frame: (nc, npe1work, nro) -> combined image (n, n).  ``skip`` is
    the frame's global profile offset (skip_angles + z*prof_slide)."""
    _check_ported(cfg)
    npe = data_window.shape[-2]
    angles = spoke_angles(npe, cfg.scheme_for("adjoint"), skip, device=data_window.device)
    if cfg.niter > 0:
        coilimg = cgnr_radial2d(data_window, angles, cfg)
    else:
        coilimg = nufft_adjoint(data_window, angles, cfg)
    return _combine(coilimg, cfg)


def recon_frames(
    data: torch.Tensor,
    cfg: ReconConfig,
    npe1work: int,
    prof_slide: int,
    nz: int,
    skip0: int = 0,
) -> torch.Tensor:
    """All frames on data's device. data: (nc, npe1, nro) -> (nz, n, n).
    ``skip0`` is the global profile offset of data[..., 0, :]."""
    _check_ported(cfg)
    nro = data.shape[-1]
    if cfg.niter == 0 and planes_path_ok(cfg):
        # hoist the once-per-acquisition half of the gridder's sample prep
        # (SDC, edge mask, complex->plane relayout) out of the frame loop;
        # each frame is then a contiguous slice of the spoke axis
        nxos = int((nro // 2) * cfg.gridos)
        w = sdc_weights(cfg, nro, npe1work, data.device).to(data.dtype)
        planes = grid_cuda.to_sample_planes(data * w, nxos)
        scheme = cfg.scheme_for("adjoint")

        def one(z):
            pe0 = z * prof_slide
            win = planes[pe0 : pe0 + npe1work]
            angles = spoke_angles(
                npe1work, scheme, cfg.skip_angles + skip0 + pe0, device=data.device
            )
            return _combine(nufft_adjoint_planes(win, angles, cfg), cfg)

    else:

        def one(z):
            pe0 = z * prof_slide
            win = data[..., pe0 : pe0 + npe1work, :]
            return reconstruct_frame(win, cfg.skip_angles + skip0 + pe0, cfg)

    return _map_frames(one, nz)


def incremental_applicable(cfg: ReconConfig, work: int, slide: int, nz: int) -> bool:
    """True when the telescoping sliding-window path is valid: plain adjoint
    (no CGNR), golden-angle scheme (a spoke's angle depends on its global
    profile index, `src/tron.cu:509`), and overlapping windows."""
    return (
        cfg.niter == 0
        and cfg.scheme_for("adjoint") == AngleScheme.GOLDEN
        and 0 < slide < work
        and nz > 1
    )


def recon_frames_incremental(
    data: torch.Tensor,
    cfg: ReconConfig,
    npe1work: int,
    prof_slide: int,
    nz: int,
    skip0: int = 0,
) -> torch.Tensor:
    """Telescoping sliding-window recon.  Same contract as recon_frames.

    Gridding is linear over spokes and a golden-angle spoke's footprint
    depends only on its global profile index, so the first window is gridded
    once and each later frame advances by one signed gridding call of
    2*slide spokes (leaving spokes negated, entering ones as they are):

        kgrid[z+1] = kgrid[z] - grid(spokes[z*s : z*s+s])
                              + grid(spokes[z*s+w : z*s+w+s])
    """
    _check_ported(cfg)
    nro = data.shape[-1]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    scheme = cfg.scheme_for("adjoint")
    # SDC weights use the *frame* spoke count (reference parity,
    # src/tron.cu:405-416) and are applied once, upstream of every call
    w = sdc_weights(cfg, nro, npe1work, data.device).to(data.dtype)
    dw = data * w

    if planes_path_ok(cfg):
        _kernel_backend(cfg, data.device)
        src = grid_cuda.to_sample_planes(dw, nxos)   # (npe1, nxos, 2C)
        spoke_axis = 0

        tuning = cfg.kernel_tuning()

        def gridw(win, angles):
            return grid_cuda.grid_radial2d_planes(
                win, angles, nxos, cfg.kernwidth, beta, matmul_dtype=cfg.matmul_dtype,
                tuning=tuning,
            )

    else:
        src = dw                                      # (C, npe1, nro)
        spoke_axis = -2
        backend = _grid_backend(cfg, data.device)

        def gridw(win, angles):
            return backend(win, angles, nxos, cfg.kernwidth, beta)

    def window(pe0, m):
        return src.narrow(spoke_axis, pe0, m)

    def angles_of(pe0, m):
        return spoke_angles(m, scheme, cfg.skip_angles + skip0 + pe0, device=data.device)

    def frame_image(kg):
        return _combine(_adjoint_epilogue(kg, n, cfg, beta), cfg)

    return incremental_scan(
        window, angles_of, gridw, frame_image, npe1work, prof_slide, nz,
        spoke_axis=spoke_axis,
    )


def incremental_scan(
    window, angles_of, gridw, frame_image,
    work: int, slide: int, nframes: int,
    z0: int = 0, spoke_axis: int = 0,
) -> torch.Tensor:
    """The telescoping core: frame_image outputs for frames z0 ..
    z0 + nframes - 1.

    ``window(pe0, m)`` slices m spokes at global spoke offset pe0;
    ``angles_of(pe0, m)`` gives their angles; ``gridw(win, angles)`` grids
    them with its own 1/(nxos*m) scale, which deltas re-scale to the frame's
    1/(nxos*work) here; ``frame_image(kgrid)`` runs epilogue + combine.
    """
    kg = gridw(window(z0 * slide, work), angles_of(z0 * slide, work))
    img0 = frame_image(kg)
    out = img0.new_empty((nframes,) + tuple(img0.shape))
    out[0] = img0
    # every gridding call scales by 1/(nxos * npe_of_call); deltas must carry
    # the frame scale 1/(nxos * work) instead
    corr = (2.0 * slide) / work
    for i in range(1, nframes):
        pe0 = (z0 + i - 1) * slide
        win = torch.cat([-window(pe0, slide), window(pe0 + work, slide)], dim=spoke_axis)
        ang = torch.cat([angles_of(pe0, slide), angles_of(pe0 + work, slide)])
        # the carried grid is owned here (a fresh gridder output), so it is
        # updated in place where the JAX scan carries a new array
        kg += gridw(win, ang) * corr
        out[i] = frame_image(kg)
    return out


def recon_radial2d(
    indata: np.ndarray,
    cfg: ReconConfig,
    half_readback: bool = False,
    *,
    device: torch.device | str,
) -> np.ndarray:
    """Host-level recon on ``device``, mimicking the reference program's
    contract.

    adjoint: indata (nc, nt, nro, npe1) [+ optional trailing npe2 axis] ->
    images (nz, nt, n, n) complex64 (the CLI relabels to .ra dims (1, nt,
    nx, ny, nz)); CGNR when cfg.niter > 0.

    forward: indata (nc, nt, nx, ny, nz) images -> samples (nz, nc, nt,
    npe1, nro) complex64 with nro = gridos*nx and npe1 = u*nro, every frame
    on the one angle set that starts at skip_angles.

    ``half_readback`` casts adjoint images to float16 on the device before
    the transfer."""
    if cfg.koosh:
        _unported("-3 stack-of-stars (koosh)", "A15")
    if not cfg.adjoint:
        return _forward_radial2d(indata, cfg, device)
    _check_ported(cfg)
    nc, nt, nro, npe1 = indata.shape[:4]
    if 0 < cfg.coil_compress < nc:
        _unported("coil_compress", "A16")
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    # ops layout: channels = nt*nc, spokes, readout
    dnp = np.ascontiguousarray(
        np.transpose(indata.reshape(nc, nt, nro, npe1, -1)[..., 0], (1, 0, 3, 2)),
        dtype=np.complex64,
    ).reshape(nt * nc, npe1, nro)
    d = torch.from_numpy(dnp).to(device)
    frames_fn = (
        recon_frames_incremental
        if cfg.incremental and incremental_applicable(cfg, work, slide, nz)
        else recon_frames
    )
    if nt > 1:
        # combine coils per repetition
        d = d.reshape(nt, nc, npe1, nro)
        out = torch.stack([frames_fn(d[t], cfg, work, slide, nz) for t in range(nt)], dim=1)
        return _fetch_host(out, half_readback)
    out = frames_fn(d, cfg, work, slide, nz)  # (nz, n, n)
    return _fetch_host(out, half_readback)[:, None]


def _stream_coil_basis(path, npe1: int, ncomp: int, chunk: int = 4096) -> np.ndarray:
    """Global SVD coil-compression basis from a windowed disk pass
    (counterpart of `tron_tpu/recon.py:351-375`).

    Accumulates the whole-acquisition coil Gram G_t = X_t X_t^H per
    repetition in chunks of profiles (the file never fully enters RAM),
    then takes the top-``ncomp`` eigenvectors: the Buehrer/Huang SCC basis.
    Returns (nt, nc, ncomp) complex64."""
    from tron_tpu_torch.io.native import ra_read_profiles

    G = None
    for pe0 in range(0, npe1, chunk):
        blk = ra_read_profiles(path, pe0, min(chunk, npe1 - pe0))
        nc, nt = blk.shape[:2]
        X = blk.transpose(1, 0, 2, 3).reshape(nt, nc, -1)
        # per-chunk Gram in c64 BLAS, accumulated in c128
        g = np.einsum("tcm,tdm->tcd", X, X.conj()).astype(np.complex128)
        G = g if G is None else G + g
    basis = np.empty((G.shape[0], G.shape[1], ncomp), np.complex64)
    for t in range(G.shape[0]):
        _, vecs = np.linalg.eigh(G[t])          # ascending eigenvalues
        basis[t] = vecs[:, ::-1][:, :ncomp]     # top-ncomp components
    return basis


class _Uploader:
    """Host -> device copies of the streamed blocks.  On the card: two
    pinned host buffers used in turn, each copy on a dedicated stream with
    an event the compute stream waits on, and a buffer refilled only after
    its previous copy's event has completed (the reference's NSTREAMS=2
    pinned async H2D, `src/tron.cu:734-781`).  On the CPU: a plain tensor."""

    def __init__(self, device: torch.device, shape: tuple[int, ...]):
        self.device = device
        if device.type == "cuda":
            self.pinned = [
                torch.empty(shape, dtype=torch.complex64, pin_memory=True) for _ in range(2)
            ]
            self.copied = [None, None]
            self.stream = torch.cuda.Stream(device)

    def __call__(self, i: int, arr: np.ndarray):
        """Block ``i`` -> (device tensor, event or None)."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.complex64)), None
        k = i % 2
        if self.copied[k] is not None:
            self.copied[k].synchronize()
        self.pinned[k].numpy()[...] = arr
        with torch.cuda.stream(self.stream):
            d = self.pinned[k].to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.copied[k] = ev
        return d, ev


def _download(dev: torch.Tensor, ready, stream) -> np.ndarray:
    """Device block -> host array.  On the card the copy runs on ``stream``
    after the ``ready`` event, into a pinned buffer that is synchronised
    before numpy reads it."""
    if dev.device.type != "cuda":
        return dev.numpy()
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host.numpy()


def recon_radial2d_streaming(
    path,
    cfg: ReconConfig,
    batch_frames: int = 64,
    mesh=None,
    writer=None,
    half: bool = False,
    *,
    device: torch.device | str | None = None,
) -> np.ndarray | None:
    """Sliding-window adjoint recon streamed from disk (counterpart of
    `tron_tpu/recon.py:378-536`), on ``device`` (default: the card,
    ``resolve_device()``).

    A three-stage overlap, the reference's NSTREAMS=2 stream pool with
    pinned-memory async copies (`src/tron.cu:734-781`):

      * a LOADER thread reads the next block's profile window from disk
        (``io.native.ra_read_profiles``: the acquisition never fully enters
        host RAM), projects it onto the coil-compression basis if any, and
        uploads it from a pinned buffer on its own copy stream;
      * the main thread makes the compute stream wait for that copy and
        dispatches the block's frames (``recon_frames``, or
        ``recon_frames_incremental`` when applicable; CGNR with ``niter``);
      * a READER thread copies each finished block back into pinned host
        memory after the block's compute event and hands it to the sink.

    ``writer(z0, block)``: optional sink called in block order with the host
    images of frames [z0, z0+bf); the CLI lands each block in its region of
    the output .ra (``io.RaWriter``).  Tail blocks realign to nz - bf, so a
    later call may rewrite earlier frames.  When given, returns None.

    ``half=True`` casts the images to float16 on the card before readback;
    blocks are then float16 re/im planes on a leading axis of 2, the pair
    convention of the ``--half`` output.  Block shapes: (bf, nt, n, n), or
    (bf, nt, nc, n, n) for coil_combine='none'; with half, (2, bf, nt,
    [nc,] n, n).  Inputs may be complex, plain float or float16 re/im-pair
    files.  Coil compression (cfg.coil_compress) runs a disk-only first
    pass for the global virtual-coil basis (``_stream_coil_basis``), then
    projects each block on the host before upload.

    Without ``writer``, returns all frames stacked: (nz, nt, [nc,] n, n)
    complex64, or (2, nz, nt, [nc,] n, n) float16 when half.  ``mesh``
    (frame-sharded streaming) is not ported yet.
    """
    from concurrent.futures import ThreadPoolExecutor

    from tron_tpu_torch.device import resolve_device
    from tron_tpu_torch.io import ra_query
    from tron_tpu_torch.io.native import ra_read_profiles, radial_dims

    if mesh is not None:
        _unported("mesh (frame-sharded streaming)", "A17")
    device = resolve_device() if device is None else torch.device(device)
    hdr = ra_query(path)
    nc, nt, nro, npe1, npe2, _pair = radial_dims(hdr)
    if npe2 != 1:
        raise ValueError("streaming recon supports npe2 == 1 (use -3 for stacks)")
    if not cfg.adjoint or cfg.koosh:
        raise ValueError("streaming recon is adjoint (-a), non-koosh only")
    _check_ported(cfg)
    basis = None
    if 0 < cfg.coil_compress < nc:
        # a per-block basis would change the virtual coils across blocks, so
        # one disk-only pass fixes the global basis before any upload
        basis = _stream_coil_basis(path, npe1, cfg.coil_compress)
    nv = nc if basis is None else basis.shape[-1]
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    bf = min(batch_frames, nz)
    # the tail block realigns to nz - bf (every block has one shape)
    z0s = [min(z0, nz - bf) for z0 in range(0, nz, bf)]
    npe_blk = work + (bf - 1) * slide
    frames_fn = (
        recon_frames_incremental
        if cfg.incremental and incremental_applicable(cfg, work, slide, bf)
        else recon_frames
    )
    upload = _Uploader(device, (nt, nv, npe_blk, nro))
    d2h = torch.cuda.Stream(device) if device.type == "cuda" else None

    def load(i):
        """Disk window -> device (loader thread)."""
        pe0 = z0s[i] * slide
        blk = ra_read_profiles(path, pe0, npe_blk)      # (nc, nt, nro, npe)
        if basis is not None:
            # per-repetition projection onto the global virtual-coil basis
            arr = np.einsum("tck,tcpr->tkpr", basis.conj(), blk.transpose(1, 0, 3, 2))
        else:
            arr = blk.transpose(1, 0, 3, 2)             # (nt, nc, npe, nro)
        return (*upload(i, arr), pe0)

    def recon_block(d, pe0) -> torch.Tensor:
        """All repetitions of one block, stacked on the card."""
        outs = [frames_fn(d[t], cfg, work, slide, bf, pe0) for t in range(nt)]
        if half:
            return torch.stack([torch.stack([o.real, o.imag]) for o in outs], dim=2).to(
                torch.float16
            )
        return torch.stack(outs, dim=1)

    outs = None if writer is not None else [None] * nz

    def sink(z0, dev, ready):
        """Device block -> host -> writer or outs (reader thread, block order)."""
        blk = _download(dev, ready, d2h)
        if writer is not None:
            writer(z0, blk)
            return
        for i in range(bf):
            # the frame axis is axis 0 (plain) or axis 1 (half's leading planes)
            outs[z0 + i] = blk[:, i].copy() if half else blk[i].copy()

    with ThreadPoolExecutor(max_workers=1) as loader, ThreadPoolExecutor(max_workers=1) as reader:
        fut = loader.submit(load, 0)
        pending = []
        for i, z0 in enumerate(z0s):
            d, copied, pe0 = fut.result()
            if i + 1 < len(z0s):
                fut = loader.submit(load, i + 1)
            ready = None
            if copied is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(copied)
                d.record_stream(compute)  # d was allocated on the copy stream
            out = recon_block(d, pe0)
            del d
            if device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(device))
            pending.append(reader.submit(sink, z0, out, ready))
            del out
            while len(pending) > 1:
                pending.pop(0).result()
        while pending:
            pending.pop(0).result()
    if writer is not None:
        return None
    return np.stack(outs, axis=1 if half else 0)


def _forward_radial2d(indata: np.ndarray, cfg: ReconConfig, device) -> np.ndarray:
    """The forward branch of recon_radial2d: each image frame z (all coils
    and repetitions as channels) is one nufft_forward call."""
    nc, nt, nx, ny, nz = indata.shape[:5]
    nro = int(cfg.gridos * nx)
    npe1 = int(cfg.data_undersamp * nro)
    # (nc, nt, nx, ny, nz) -> (nz, nc*nt, ny, nx) host-side
    imgs = np.ascontiguousarray(
        np.transpose(np.asarray(indata), (4, 0, 1, 3, 2)), dtype=np.complex64
    ).reshape(nz, nc * nt, ny, nx)
    d = torch.from_numpy(imgs).to(device)
    angles = spoke_angles(npe1, cfg.scheme_for("forward"), cfg.skip_angles, device=d.device)
    out = _map_frames(lambda z: nufft_forward(d[z], angles, cfg, nro=nro), nz)
    return out.cpu().numpy().reshape(nz, nc, nt, npe1, nro)
