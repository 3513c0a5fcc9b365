"""Frames x coils over a process mesh (counterpart of
`tron_tpu/parallel/mesh.py`).

Frames are the long axis of a golden-angle acquisition and independent of
each other: they shard over the 'frame' axis with no communication.  Coils
shard over 'coil'; the only traffic inside the recon is what finishes the
coil combine (one all_reduce of a real image for sum of squares, one
all_gather of coil images for Walsh) and, with CGNR, the three all_reduced
inner products of an iteration.  Per-frame FFTs stay on one device.

Every rank calls an entry point with the same, whole input (the profile
stream is replicated along 'frame', because windows overlap) and gets the
whole result back: where JAX returns one global array, the ranks here
all_gather their shards over 'frame' (and over 'coil' for coil images) at the
end.  The partition is JAX's: frame coordinate ``f`` owns the ``per =
ceil(nz / n_frame)`` frames from ``f * per``.  JAX pads the frame count to
the mesh and recomputes the last frame; here the last coordinates own fewer
frames (or none) and only the gather is padded.  All ranks of a coil group
share a frame coordinate, so they run the same number of collectives.

Nothing is compiled, so the JAX module's cache of compiled steps has no
counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.nufft import nufft_forward
from tron_tpu_torch.parallel.distributed import (
    MeshAxis,
    ProcessMesh,
    all_gather_cat,
    frame_slice,
    world_size,
)
from tron_tpu_torch.recon import (
    _koosh_kz_ifft,
    _koosh_slice_block,
    _map_frames,
    _upload,
    incremental_applicable,
    recon_frames,
    recon_frames_incremental,
)
from tron_tpu_torch.trajectory import spoke_angles


def make_mesh(n_frame: int | None = None, n_coil: int = 1, device=None) -> ProcessMesh:
    """('frame', 'coil') mesh over the ranks of the world (one rank, and no
    process group, when `torch.distributed` is not initialised).  ``device``
    is the device this rank computes on (default: the one given to
    ``distributed.initialize``, else the card)."""
    world = world_size()
    if n_frame is None:
        n_frame = world // n_coil
    return ProcessMesh.create(("frame", "coil"), (n_frame, n_coil), device)


def _gather_shards(local: torch.Tensor, axis: MeshAxis, total: int) -> torch.Tensor:
    """Shards of unequal length along dim 0 (``frame_slice`` of ``total``
    over ``axis``) -> all ``total`` rows on every rank: each shard is padded
    to the common length, gathered, and the padding cut off the end."""
    if axis.size == 1:
        return local
    per = -(-total // axis.size)
    if local.shape[0] < per:
        pad = local.new_zeros((per - local.shape[0],) + tuple(local.shape[1:]))
        local = torch.cat([local, pad])
    return all_gather_cat(local, axis, dim=0)[:total]


def recon_frames_shard(
    rows: torch.Tensor,
    cfg: ReconConfig,
    mesh: ProcessMesh,
    npe1work: int,
    prof_slide: int,
    nloc: int,
    skip0: int,
    incremental: bool,
) -> torch.Tensor:
    """This rank's share of a sharded recon, before the gather: ``nloc``
    frames from ``rows`` (nc, npe1work + (nloc-1)*prof_slide, nro), the
    profiles of this rank's frames at all coils, ``skip0`` the global offset
    of rows[:, 0].  The rank takes its coil shard; the combine and the CGNR
    inner products finish over 'coil'.  -> (nloc, [nc/n_coil,] n, n).

    Frames z0 .. z0+nloc-1 of a series are frames 0 .. nloc-1 of the series
    that starts z0*prof_slide profiles later, so the unsharded schedulers
    run here unchanged, each shard telescoping from its own first frame when
    ``incremental``."""
    coil = mesh.axis("coil")
    nc, _, nro = rows.shape
    if nc % coil.size:
        raise ValueError(f"nc={nc} must divide over coil axis {coil.size}")
    ncl = nc // coil.size
    n = nro // 2
    if nloc == 0:
        tail = (ncl, n, n) if cfg.coil_combine == "none" else (n, n)
        return rows.new_zeros((0,) + tail)
    d_local = rows[coil.index * ncl : (coil.index + 1) * ncl]
    frames_fn = recon_frames_incremental if incremental else recon_frames
    return frames_fn(d_local, cfg, npe1work, prof_slide, nloc, skip0, coil_axis=coil)


def gather_frames(local: torch.Tensor, cfg: ReconConfig, mesh: ProcessMesh, nz: int) -> torch.Tensor:
    """The shards of ``recon_frames_shard`` -> all ``nz`` frames on every
    rank; for coil images ('none') the coil shards are joined first."""
    if cfg.coil_combine == "none":
        local = all_gather_cat(local, mesh.axis("coil"), dim=1)
    return _gather_shards(local, mesh.axis("frame"), nz)


def recon_frames_sharded(
    data: torch.Tensor,
    cfg: ReconConfig,
    mesh: ProcessMesh,
    npe1work: int,
    prof_slide: int,
    nz: int,
    skip0: int = 0,
) -> torch.Tensor:
    """Sharded sliding-window recon. data: (nc, npe1, nro), the same on
    every rank -> (nz, n, n) on every rank.

    ``skip0`` is the global profile offset of data[..., 0, :] within the
    whole acquisition (the ``recon_frames`` contract): the streamed recon
    feeds overlapping disk blocks through here by varying it.

    Frames are partitioned over 'frame', channels over 'coil'; each rank
    reconstructs its (frames x coils) block and the coil combine finishes
    over 'coil' per cfg.coil_combine:

      * "sos": partial sum of squares + all_reduce (one real image, the
        cheapest collective there is);
      * "walsh": all_gather of the coil shards (Walsh's eigenvector filter
        needs the full coil covariance), then the local Walsh combine;
      * "none": coil images, gathered over 'coil' at the end (output
        (nz, nc, n, n)).
    """
    frame = mesh.axis("frame")
    mine = frame_slice(nz, frame.size, frame.index)
    nloc = mine.stop - mine.start
    pe0 = mine.start * prof_slide
    rows = data[:, pe0 : pe0 + npe1work + (max(nloc, 1) - 1) * prof_slide]
    incremental = cfg.incremental and incremental_applicable(cfg, npe1work, prof_slide, nz)
    local = recon_frames_shard(
        rows, cfg, mesh, npe1work, prof_slide, nloc, skip0 + pe0, incremental
    )
    return gather_frames(local, cfg, mesh, nz)


def recon_stack_of_stars_sharded(
    indata: np.ndarray, cfg: ReconConfig, mesh: ProcessMesh
) -> np.ndarray:
    """Slice-sharded 3-D stack-of-stars adjoint.  After the kz inverse FFT,
    which mixes every npe2 encoding of a sample and so runs whole on every
    rank (one batched 1-D FFT), the npe2 slices are as independent as frames
    and shard over 'frame'; ranks along 'coil' repeat their slices.
    indata: 5-D .ra layout (nc, nt, nro, npe1, npe2), the same on every rank;
    returns (npe2*nzi, nt, [nc,] n, n) on every rank, as recon_radial2d's
    `-3` adjoint."""
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    nc, nt, nro, npe1, npe2 = indata.shape[:5]
    work, slide, nzi = cfg2.frame_geometry(nro, npe1)
    sl = _koosh_kz_ifft(_upload(indata, mesh.device))       # (npe2, nt, nc, npe1, nro)
    frame = mesh.axis("frame")
    mine = frame_slice(npe2, frame.size, frame.index)
    nb = mine.stop - mine.start
    n = nro // 2
    if nb:
        local = _koosh_slice_block(sl, mine.start, nb, cfg2, work, slide, nzi)
    else:
        tail = (nc, n, n) if cfg.coil_combine == "none" else (n, n)
        local = sl.new_zeros((0, nzi, nt) + tail)
    out = _gather_shards(local, frame, npe2)               # (npe2, nzi, nt, [nc,] n, n)
    return out.reshape((npe2 * nzi,) + tuple(out.shape[2:])).cpu().numpy()


def recon_forward_sharded(indata: np.ndarray, cfg: ReconConfig, mesh: ProcessMesh) -> np.ndarray:
    """Frame(+coil)-sharded forward degridding (2-D series and `-3` stacks).

    Image slices degrid independently (the hot O(nro*npe*(2kw)^2) work,
    `src/tron.cu:540-577`), so they shard over 'frame' with no communication,
    channels likewise over 'coil'.  For `-3` the centred kz FFT mixes all
    slices, so it runs after the gather of the (cheap, already degridded)
    samples, whole on every rank.

    indata: image .ra layout (nc, nt, nx, ny, nz), the same on every rank;
    returns (nz, nc, nt, npe1, nro) on every rank, as recon_radial2d's
    forward.  nc*nt must divide over the 'coil' axis."""
    koosh = bool(cfg.koosh)
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0) if koosh else cfg
    nc, nt, nx, ny, nz = indata.shape[:5]
    nro = int(cfg2.gridos * nx)
    npe1 = int(cfg2.data_undersamp * nro)
    frame, coil = mesh.axis("frame"), mesh.axis("coil")
    nC = nc * nt
    if nC % coil.size:
        raise ValueError(f"nc*nt={nC} must divide over coil axis {coil.size}")
    ncl = nC // coil.size
    mine = frame_slice(nz, frame.size, frame.index)
    # (nc, nt, nx, ny, nz) -> this rank's (slices, channels, ny, nx), host-side
    imgs = np.ascontiguousarray(
        np.transpose(np.asarray(indata), (4, 0, 1, 3, 2)), dtype=np.complex64
    ).reshape(nz, nC, ny, nx)[mine, coil.index * ncl : (coil.index + 1) * ncl]
    d = torch.from_numpy(np.ascontiguousarray(imgs)).to(mesh.device)
    angles = spoke_angles(npe1, cfg2.scheme_for("forward"), cfg2.skip_angles, device=d.device)
    if d.shape[0]:
        local = _map_frames(lambda z: nufft_forward(d[z], angles, cfg2, nro=nro), d.shape[0])
    else:
        local = d.new_zeros((0, ncl, npe1, nro))
    data = _gather_shards(all_gather_cat(local, coil, dim=1), frame, nz)   # (nz, nC, npe1, nro)
    if koosh:
        data = torch.fft.fftshift(torch.fft.fft(torch.fft.ifftshift(data, dim=0), dim=0), dim=0)
    return data.cpu().numpy().reshape(nz, nc, nt, npe1, nro)
