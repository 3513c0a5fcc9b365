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

        def gridw(win, angles):
            return grid_cuda.grid_radial2d_planes(
                win, angles, nxos, cfg.kernwidth, beta, matmul_dtype=cfg.matmul_dtype
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
