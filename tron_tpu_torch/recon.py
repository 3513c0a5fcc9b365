"""Reconstruction entry points (counterpart of `tron_tpu/recon.py`):
sliding-window frame scheduling over radial data (adjoint, plain or CGNR),
the forward operator over image stacks, and the 3-D stack-of-stars (`-3`)
recon, in memory and streamed.

Frames run in order in a Python loop, each written into one preallocated
output (the JAX package's ``lax.map`` / ``lax.scan``).  The frame schedulers
take a ``coil_axis`` (a ``parallel.distributed.MeshAxis``) when the coils
they are given are one shard of a mesh's 'coil' axis: the coil combine and
the CGNR inner products then finish over that axis (`parallel/mesh.py`).
Under a profiler the host driver's stages, each scheduler's sample prep
and each frame are spans (`tracing.py`).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tron_tpu_torch.config import AngleScheme, ReconConfig
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.nufft import (
    _adjoint_epilogue,
    _grid_backend,
    _kernel_backend,
    kernel_class,
    nufft_adjoint,
    nufft_adjoint_planes,
    nufft_forward,
    planes_path_ok,
    sdc_weights,
)
from tron_tpu_torch.ops import grid_cuda
from tron_tpu_torch.ops.coil import coil_combine_sos, coil_combine_walsh, coil_compress
from tron_tpu_torch.parallel.distributed import MeshAxis, all_gather_cat, psum
from tron_tpu_torch.solver import cgnr_radial2d
from tron_tpu_torch.tracing import span
from tron_tpu_torch.trajectory import spoke_angles


def _fetch_host(dev: torch.Tensor, half: bool) -> np.ndarray:
    """Device images -> host complex64.  ``half`` casts to float16 re/im
    planes on the device before the transfer (2x fewer bytes) and
    recombines on the host, value-identical to a later host-side --half
    store."""
    with span("tron.readback"):
        if half:
            return _from_half_planes(_to_half_planes(dev).cpu().numpy())
        return dev.cpu().numpy()


def _to_half_planes(dev: torch.Tensor) -> torch.Tensor:
    """Complex images -> float16 re/im planes on a leading axis of 2."""
    return torch.stack([dev.real, dev.imag]).to(torch.float16)


def _from_half_planes(planes: np.ndarray) -> np.ndarray:
    return (planes[0].astype(np.float32) + 1j * planes[1].astype(np.float32)).astype(
        np.complex64
    )


def _combine(
    coilimg: torch.Tensor, cfg: ReconConfig, coil_axis: MeshAxis | None = None
) -> torch.Tensor:
    """Coil images (C, n, n) -> the frame per cfg.coil_combine.  With the
    coils sharded over ``coil_axis``: "sos" sums the shards' partial sums of
    squares over the axis (one real image all_reduced), "walsh" gathers the
    coil shards first (its eigenvector filter needs the full covariance),
    "none" leaves the shard as it is."""
    sharded = coil_axis is not None and coil_axis.size > 1
    if cfg.coil_combine == "walsh":
        if sharded:
            coilimg = all_gather_cat(coilimg, coil_axis, dim=0)
        return coil_combine_walsh(coilimg, cfg.walsh_npatch)
    if cfg.coil_combine == "sos":
        if sharded:
            part = torch.sum(torch.abs(coilimg) ** 2, dim=0)
            return torch.sqrt(psum(part, coil_axis)).to(coilimg.dtype)
        return coil_combine_sos(coilimg, axis=0)
    if cfg.coil_combine == "none":
        return coilimg
    raise ValueError(f"coil_combine must be 'sos', 'walsh' or 'none', got {cfg.coil_combine!r}")


def _map_frames(one, nz: int) -> torch.Tensor:
    """Frames 0..nz-1 in order, written into one preallocated output."""
    with span("tron.frame"):
        first = one(0)
        out = first.new_empty((nz,) + tuple(first.shape))
        out[0] = first
    for z in range(1, nz):
        with span("tron.frame"):
            out[z] = one(z)
    return out


def reconstruct_frame(
    data_window: torch.Tensor, skip, cfg: ReconConfig, coil_axis: MeshAxis | None = None
) -> torch.Tensor:
    """One frame: (nc, npe1work, nro) -> combined image (n, n).  ``skip`` is
    the frame's global profile offset (skip_angles + z*prof_slide)."""
    npe = data_window.shape[-2]
    angles = spoke_angles(npe, cfg.scheme_for("adjoint"), skip, device=data_window.device)
    if cfg.niter > 0:
        # with sharded coils the CG inner products are global over the shards
        sharded = coil_axis is not None and coil_axis.size > 1
        coilimg = cgnr_radial2d(
            data_window, angles, cfg, reduce_axes=(coil_axis,) if sharded else ()
        )
    else:
        coilimg = nufft_adjoint(data_window, angles, cfg)
    return _combine(coilimg, cfg, coil_axis)


def recon_frames(
    data: torch.Tensor,
    cfg: ReconConfig,
    npe1work: int,
    prof_slide: int,
    nz: int,
    skip0: int = 0,
    coil_axis: MeshAxis | None = None,
) -> torch.Tensor:
    """All frames on data's device. data: (nc, npe1, nro) -> (nz, n, n).
    ``skip0`` is the global profile offset of data[..., 0, :]; ``coil_axis``
    the mesh axis that ``data``'s coils are one shard of, if any."""
    nro = data.shape[-1]
    if cfg.niter == 0 and planes_path_ok(cfg):
        # hoist the once-per-acquisition half of the gridder's sample prep
        # (SDC, edge mask, complex->plane relayout) out of the frame loop;
        # each frame is then a contiguous slice of the spoke axis
        nxos = int((nro // 2) * cfg.gridos)
        with span("tron.prep"):
            w = sdc_weights(cfg, nro, npe1work, data.device).to(data.dtype)
            planes = grid_cuda.to_sample_planes(data * w, nxos)
        scheme = cfg.scheme_for("adjoint")

        def one(z):
            pe0 = z * prof_slide
            win = planes[pe0 : pe0 + npe1work]
            angles = spoke_angles(
                npe1work, scheme, cfg.skip_angles + skip0 + pe0, device=data.device
            )
            return _combine(nufft_adjoint_planes(win, angles, cfg), cfg, coil_axis)

    else:

        def one(z):
            pe0 = z * prof_slide
            win = data[..., pe0 : pe0 + npe1work, :]
            return reconstruct_frame(win, cfg.skip_angles + skip0 + pe0, cfg, coil_axis)

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
    coil_axis: MeshAxis | None = None,
) -> torch.Tensor:
    """Telescoping sliding-window recon.  Same contract as recon_frames.

    Gridding is linear over spokes and a golden-angle spoke's footprint
    depends only on its global profile index, so the first window is gridded
    once and each later frame advances by one signed gridding call of
    2*slide spokes (leaving spokes negated, entering ones as they are):

        kgrid[z+1] = kgrid[z] - grid(spokes[z*s : z*s+s])
                              + grid(spokes[z*s+w : z*s+w+s])
    """
    nro = data.shape[-1]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    scheme = cfg.scheme_for("adjoint")
    # SDC weights use the *frame* spoke count (reference parity,
    # src/tron.cu:405-416) and are applied once, upstream of every call
    on_planes = planes_path_ok(cfg)
    with span("tron.prep"):
        w = sdc_weights(cfg, nro, npe1work, data.device).to(data.dtype)
        src = data * w                                    # (C, npe1, nro)
        if on_planes:
            _kernel_backend(cfg, data.device)
            src = grid_cuda.to_sample_planes(src, nxos)   # (npe1, nxos, 2C)

    if on_planes:
        spoke_axis = 0

        tuning = cfg.kernel_tuning()
        mm_class = kernel_class(cfg, data.device)

        def gridw(win, angles):
            return grid_cuda.grid_radial2d_planes(
                win, angles, nxos, cfg.kernwidth, beta, matmul_dtype=mm_class, tuning=tuning,
            )

    else:
        spoke_axis = -2
        backend = _grid_backend(cfg, data.device)

        def gridw(win, angles):
            return backend(win, angles, nxos, cfg.kernwidth, beta)

    def window(pe0, m):
        return src.narrow(spoke_axis, pe0, m)

    def angles_of(pe0, m):
        return spoke_angles(m, scheme, cfg.skip_angles + skip0 + pe0, device=data.device)

    def frame_image(kg):
        return _combine(_adjoint_epilogue(kg, n, cfg, beta), cfg, coil_axis)

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
    with span("tron.frame"):
        kg = gridw(window(z0 * slide, work), angles_of(z0 * slide, work))
        img0 = frame_image(kg)
        out = img0.new_empty((nframes,) + tuple(img0.shape))
        out[0] = img0
    # every gridding call scales by 1/(nxos * npe_of_call); deltas must carry
    # the frame scale 1/(nxos * work) instead
    corr = (2.0 * slide) / work
    for i in range(1, nframes):
        with span("tron.frame"):
            pe0 = (z0 + i - 1) * slide
            win = torch.cat([-window(pe0, slide), window(pe0 + work, slide)], dim=spoke_axis)
            ang = torch.cat([angles_of(pe0, slide), angles_of(pe0 + work, slide)])
            # the carried grid is owned here (a fresh gridder output), so it
            # is updated in place where the JAX scan carries a new array
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

    With ``cfg.koosh`` (`-3`) the trailing axis is the kz phase encoding of
    a stack of stars; see ``_recon_stack_of_stars`` for its shapes.

    ``half_readback`` casts adjoint images to float16 on the device before
    the transfer."""
    if cfg.koosh:
        return _recon_stack_of_stars(indata, cfg, half_readback, device)
    if not cfg.adjoint:
        return _forward_radial2d(indata, cfg, device)
    nc, nt, nro, npe1 = indata.shape[:4]
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    # ops layout: channels = nt*nc, spokes, readout
    with span("tron.relayout"):
        dnp = np.ascontiguousarray(
            np.transpose(indata.reshape(nc, nt, nro, npe1, -1)[..., 0], (1, 0, 3, 2)),
            dtype=np.complex64,
        ).reshape(nt * nc, npe1, nro)
        h = torch.from_numpy(dnp)
    with span("tron.upload"):
        d = h.to(device)
    if 0 < cfg.coil_compress < nc:
        # per repetition, from that repetition's own samples
        dc = d.reshape(nt, nc, npe1, nro)
        d = torch.stack([coil_compress(dc[t], cfg.coil_compress) for t in range(nt)])
        nc = cfg.coil_compress
        d = d.reshape(nt * nc, npe1, nro)
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
        self.shape = shape
        if device.type == "cuda":
            self.pinned = [None, None]  # allocated at first use: one block needs one
            self.copied = [None, None]
            self.stream = torch.cuda.Stream(device)

    def __call__(self, i: int, arr: np.ndarray):
        """Block ``i`` -> (device tensor, event or None)."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.complex64)), None
        k = i % 2
        if self.pinned[k] is None:
            self.pinned[k] = torch.empty(self.shape, dtype=torch.complex64, pin_memory=True)
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


def _block_starts(total: int, block: int) -> list[int]:
    """Starts of blocks of one size covering [0, total): the tail block
    realigns to total - block, so it may overlap its predecessor."""
    return [min(b0, total - block) for b0 in range(0, total, block)]


class _BlockReader:
    """Reads finished device blocks back on a thread, in order, one behind
    the compute: block b is copied to the host (``_download``: a copy stream
    that waits for the block's event, pinned memory) and handed to
    ``drain(*key, host_block)`` while the card computes block b+1."""

    def __init__(self, device: torch.device, drain):
        self.device = device
        self.drain = drain
        self.d2h = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.pending = []

    def submit(self, key: tuple, dev: torch.Tensor) -> None:
        """Queue the block computed last on the current stream."""
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self.pending.append(
            self.pool.submit(lambda: self.drain(*key, _download(dev, ready, self.d2h)))
        )
        while len(self.pending) > 1:
            self.pending.pop(0).result()

    def close(self) -> None:
        try:
            while self.pending:
                self.pending.pop(0).result()
        finally:
            self.pool.shutdown()


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
    complex64, or (2, nz, nt, [nc,] n, n) float16 when half.

    ``mesh``: a ('frame', 'coil') ``parallel.ProcessMesh``.  Every rank then
    calls this on the same file and each block's frames are split over the
    mesh as ``parallel.recon_frames_sharded`` splits them, the block's
    profile offset as its skip0: a rank reads from disk only the profiles
    its own frames of the block need, reconstructs them on ``mesh.device``,
    and the block is gathered, so every rank's sink sees every block (the
    CLI gives only rank 0 one that writes).
    """
    from tron_tpu_torch.device import resolve_device
    from tron_tpu_torch.io import ra_query
    from tron_tpu_torch.io.native import ra_read_profiles, radial_dims

    if mesh is not None:
        device = mesh.device
    device = resolve_device() if device is None else torch.device(device)
    hdr = ra_query(path)
    nc, nt, nro, npe1, npe2, _pair = radial_dims(hdr)
    if npe2 != 1:
        raise ValueError("streaming recon supports npe2 == 1 (use -3 for stacks)")
    if not cfg.adjoint or cfg.koosh:
        raise ValueError("streaming recon is adjoint (-a), non-koosh only")
    basis = None
    if 0 < cfg.coil_compress < nc:
        # a per-block basis would change the virtual coils across blocks, so
        # one disk-only pass fixes the global basis before any upload
        basis = _stream_coil_basis(path, npe1, cfg.coil_compress)
    nv = nc if basis is None else basis.shape[-1]
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    bf = min(batch_frames, nz)
    z0s = _block_starts(nz, bf)  # every block has one shape
    incremental = cfg.incremental and incremental_applicable(cfg, work, slide, bf)
    if mesh is None:
        z_lo, nloc = 0, bf
        frames_fn = recon_frames_incremental if incremental else recon_frames
    else:
        from tron_tpu_torch.parallel.distributed import frame_slice
        from tron_tpu_torch.parallel.mesh import gather_frames, recon_frames_shard

        # this rank's frames of a block, the same in every block
        mine = frame_slice(bf, mesh.axis("frame").size, mesh.axis("frame").index)
        z_lo, nloc = mine.start, mine.stop - mine.start

        def frames_fn(d_t, cfg, work, slide, bf, pe0):
            local = recon_frames_shard(d_t, cfg, mesh, work, slide, nloc, pe0, incremental)
            return gather_frames(local, cfg, mesh, bf)

    npe_blk = work + (max(nloc, 1) - 1) * slide
    upload = _Uploader(device, (nt, nv, npe_blk, nro))

    def load(i):
        """Disk window -> device (loader thread)."""
        pe0 = (z0s[i] + z_lo) * slide
        if nloc == 0:  # a rank with no frame of the blocks: it only gathers
            return torch.zeros((nt, nv, 0, nro), dtype=torch.complex64, device=device), None, pe0
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

    def sink(z0, blk):
        """Host block -> writer or outs (reader thread, block order)."""
        if writer is not None:
            writer(z0, blk)
            return
        for i in range(bf):
            # the frame axis is axis 0 (plain) or axis 1 (half's leading planes)
            outs[z0 + i] = blk[:, i].copy() if half else blk[i].copy()

    reader = _BlockReader(device, sink)
    try:
        with ThreadPoolExecutor(max_workers=1) as loader:
            fut = loader.submit(load, 0)
            for i, z0 in enumerate(z0s):
                d, copied, pe0 = fut.result()
                if i + 1 < len(z0s):
                    fut = loader.submit(load, i + 1)
                if copied is not None:
                    compute = torch.cuda.current_stream(device)
                    compute.wait_event(copied)
                    d.record_stream(compute)  # d was allocated on the copy stream
                out = recon_block(d, pe0)
                del d
                reader.submit((z0,), out)
                del out
    finally:
        reader.close()
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


# -- 3-D stack of stars (`-3`) -----------------------------------------------

KZ_BLOCK = 8  # kz slices reconstructed per readback


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> complex64 device tensor of the same shape, with no
    host-side relayout when the array is contiguous in either order (a .ra
    payload read by ``ra_read`` is Fortran-ordered: it goes up as its
    transpose and is viewed back on the device)."""
    a = np.asarray(arr)
    if a.dtype != np.complex64:
        a = a.astype(np.complex64)
    if a.flags.f_contiguous and not a.flags.c_contiguous:
        return torch.from_numpy(a.T).to(device).permute(*reversed(range(a.ndim)))
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _recon_stack_of_stars(
    indata: np.ndarray, cfg: ReconConfig, half_readback: bool, device
) -> np.ndarray:
    """3-D stack of stars (`-3`): 2-D radial in plane, Cartesian phase
    encoding along kz.

    The reference's -3 flag only relabels dimensions (`src/tron.cu:922-927`);
    here, as in the JAX package, kz (npe2) is a centred Cartesian FFT axis
    decoupled from the in-plane NUFFT: the adjoint is an inverse FFT along
    kz, then a 2-D gridding recon per slice; the forward a 2-D degridding
    per slice, then an FFT along kz.  One upload per direction, the kz
    transform on the device.

    adjoint: indata (nc, nt, nro, npe1, npe2) -> (npe2*nzi, nt, [nc,] n, n),
    slice-major (frame b*nzi + z is in-plane frame z of slice b); in-plane
    frames do not overlap (prof_slide is ignored).
    forward: indata (nc, nt, nx, ny, nz) -> (nz, nc, nt, npe1, nro)."""
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    if cfg.adjoint:
        if np.ndim(indata) != 5:
            raise ValueError(f"-3 expects (nc, nt, nro, npe1, npe2), got shape {np.shape(indata)}")
        nro, npe1 = indata.shape[2:4]
        work, slide, nzi = cfg2.frame_geometry(nro, npe1)
        return _koosh_adjoint_pipelined(
            _upload(indata, device), cfg2, work, slide, nzi, half=half_readback
        )
    nc, nt, nx, ny, nz = indata.shape[:5]
    nro = int(cfg.gridos * nx)
    npe1 = int(cfg.data_undersamp * nro)
    # (nc, nt, nx, ny, nz) -> (nz, nc*nt, ny, nx), relaid on the device
    imgs = _upload(indata, device).permute(4, 0, 1, 3, 2).reshape(nz, nc * nt, ny, nx)
    out = _koosh_forward_device(imgs, cfg2, npe1, nro)
    return out.cpu().numpy().reshape(nz, nc, nt, npe1, nro)


def _koosh_kz_ifft(d5: torch.Tensor) -> torch.Tensor:
    """Centred, unnormalised inverse FFT along the kz phase axis.  d5: (nc,
    nt, nro, npe, npe2) in any strides -> (npe2, nt, nc, npe, nro)
    contiguous, so that a slice and repetition is one contiguous (nc, npe,
    nro) block for the frame machinery."""
    x = d5.permute(1, 0, 3, 2, 4).contiguous()     # kz fastest for the FFT
    x = torch.fft.fftshift(
        torch.fft.ifft(torch.fft.ifftshift(x, dim=-1), dim=-1, norm="forward"), dim=-1
    )
    return x.permute(4, 0, 1, 2, 3).contiguous()


def _koosh_slice_block(
    sl: torch.Tensor, b0: int, nb: int, cfg2: ReconConfig, work: int, slide: int, nzi: int,
    skip0: int = 0, half: bool = False,
) -> torch.Tensor:
    """kz slices [b0, b0+nb) of sl (npe2, nt, nc, npe, nro) -> images (nb,
    nzi, nt, [nc,] n, n) on the device: ``recon_frames`` per slice and
    repetition.  ``skip0`` is the global profile offset of sl[..., 0, :]:
    the streamed recon feeds profile windows through here.  ``half``
    returns float16 re/im planes on a leading axis of 2 (a readback of half
    the bytes, exact under a later --half store)."""
    nt = sl.shape[1]
    out = None
    for i in range(nb):
        for t in range(nt):
            img = recon_frames(sl[b0 + i, t], cfg2, work, slide, nzi, skip0)
            if out is None:
                out = img.new_empty((nb, nzi, nt) + tuple(img.shape[1:]))
            out[i, :, t] = img
    return _to_half_planes(out) if half else out


def _koosh_adjoint_pipelined(
    d5: torch.Tensor, cfg2: ReconConfig, work: int, slide: int, nzi: int,
    half: bool = False, kz_block: int = KZ_BLOCK,
) -> np.ndarray:
    """Host side of the -3 adjoint: the kz inverse FFT on the device, then
    blocks of ``kz_block`` kz slices reconstructed and read back one behind
    the compute (the reference's per-frame async D2H overlap,
    `src/tron.cu:767-781`).  d5: (nc, nt, nro, npe1, npe2) on the device ->
    (npe2*nzi, nt, [nc,] n, n) host array.  ``half``: float16 readback
    (exact under a later --half store)."""
    sl = _koosh_kz_ifft(d5)
    del d5
    npe2 = sl.shape[0]
    nb = min(npe2, kz_block)
    out = None

    def drain(b0, blk):                    # (nb, nzi, nt, [nc,] n, n)
        nonlocal out
        if half:
            blk = _from_half_planes(blk)
        blk = blk.reshape((nb * nzi,) + blk.shape[2:])
        if out is None:
            out = np.empty((npe2 * nzi,) + blk.shape[1:], blk.dtype)
        out[b0 * nzi : (b0 + nb) * nzi] = blk

    reader = _BlockReader(sl.device, drain)
    try:
        for b0 in _block_starts(npe2, nb):
            reader.submit((b0,), _koosh_slice_block(sl, b0, nb, cfg2, work, slide, nzi, half=half))
    finally:
        reader.close()
    return out


def recon_koosh_streaming(
    path,
    cfg: ReconConfig,
    batch_frames: int = 8,
    writer=None,
    half: bool = False,
    *,
    device: torch.device | str | None = None,
    kz_block: int = KZ_BLOCK,
) -> np.ndarray | None:
    """Streamed 3-D stack-of-stars (`-3 --stream`) adjoint on ``device``
    (default: the card, ``resolve_device()``).

    The kz inverse FFT mixes every npe2 encoding of a sample, so `-3` cannot
    stream over kz; it is pointwise over profiles, so streaming over npe1
    is exact: each disk block is the profile window of ``batch_frames``
    in-plane frames at all npe2 encodings
    (``io.native.ra_read_profiles_stack``, one contiguous region read per kz
    encoding), uploaded from pinned memory on a copy stream, transformed
    along kz on the device, then reconstructed in blocks of ``kz_block``
    slices like the in-memory path, with the window's global profile offset
    as skip0.  The host holds about two profile windows, not the
    acquisition.

    ``writer(z0, blk)`` is called with contiguous runs of output frames:
    frames are slice-major ((b, z) -> b*nzi + z, as the in-memory output and
    the .ra frame axis), so each (slice, frame window) lands as one region;
    tail blocks realign on both axes and may rewrite frames.  Without
    ``writer``, returns (npe2*nzi, nt, [nc,] n, n) complex64, comparable bit
    for bit with the in-memory `-3` output.

    ``half``: float16 readback from the card (exact under a later --half
    store); blocks reach the writer as complex64 either way."""
    from tron_tpu_torch.device import resolve_device
    from tron_tpu_torch.io import ra_query
    from tron_tpu_torch.io.native import ra_read_profiles_stack, radial_dims

    device = resolve_device() if device is None else torch.device(device)
    hdr = ra_query(path)
    nc, nt, nro, npe1, npe2, _pair = radial_dims(hdr)
    if not cfg.adjoint or not cfg.koosh:
        raise ValueError("recon_koosh_streaming runs the -3 adjoint only")
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    work, slide, nzi = cfg2.frame_geometry(nro, npe1)
    bf = min(batch_frames, nzi)
    z0s = _block_starts(nzi, bf)
    nb = min(npe2, kz_block)
    b0s = _block_starts(npe2, nb)
    npe_blk = work + (bf - 1) * slide
    # the window goes up in disk order, kz slowest (the transpose of the
    # reader's Fortran-ordered array): no host-side relayout
    upload = _Uploader(device, (npe2, npe_blk, nro, nt, nc))

    def load(i):
        """Disk window -> device (loader thread)."""
        pe0 = z0s[i] * slide
        blk = ra_read_profiles_stack(path, pe0, npe_blk)   # (nc, nt, nro, npe, npe2)
        return (*upload(i, blk.T), pe0)

    full = None

    def drain(z0, b0, blk):                # (nb, bf, nt, [nc,] n, n)
        nonlocal full
        if half:
            blk = _from_half_planes(blk)
        if writer is not None:
            for i in range(nb):
                writer((b0 + i) * nzi + z0, blk[i])
            return
        if full is None:
            full = np.empty((npe2 * nzi,) + blk.shape[2:], blk.dtype)
        for i in range(nb):
            full[(b0 + i) * nzi + z0 : (b0 + i) * nzi + z0 + bf] = blk[i]

    reader = _BlockReader(device, drain)
    try:
        with ThreadPoolExecutor(max_workers=1) as loader:
            fut = loader.submit(load, 0)
            for i, z0 in enumerate(z0s):
                dT, copied, pe0 = fut.result()
                if i + 1 < len(z0s):
                    fut = loader.submit(load, i + 1)
                if copied is not None:
                    compute = torch.cuda.current_stream(device)
                    compute.wait_event(copied)
                    dT.record_stream(compute)  # dT was allocated on the copy stream
                sl = _koosh_kz_ifft(dT.permute(4, 3, 2, 1, 0))
                del dT
                for b0 in b0s:
                    reader.submit(
                        (z0, b0),
                        _koosh_slice_block(sl, b0, nb, cfg2, work, slide, bf, pe0, half=half),
                    )
    finally:
        reader.close()
    return full if writer is None else None


def _koosh_forward_device(
    stack: torch.Tensor, cfg2: ReconConfig, npe1: int, nro: int
) -> torch.Tensor:
    """Device side of the -3 forward: per-slice degridding, every coil and
    repetition a channel of one ``nufft_forward`` call, then the centred,
    unnormalised FFT along kz.  stack: (nz, nc*nt, ny, nx) -> (npe2 = nz,
    nc*nt, npe1, nro)."""
    angles = spoke_angles(npe1, cfg2.scheme_for("forward"), cfg2.skip_angles, device=stack.device)
    data = _map_frames(lambda z: nufft_forward(stack[z], angles, cfg2, nro=nro), stack.shape[0])
    return torch.fft.fftshift(
        torch.fft.fft(torch.fft.ifftshift(data, dim=0), dim=0), dim=0
    )
