"""Spoke-sharded single-frame reconstruction (counterpart of
`tron_tpu/parallel/spoke.py`).

The frame x coil mesh (`mesh.py`) scales throughput: frames are independent.
This module scales latency instead: one frame's spokes are sharded over a
'spoke' mesh axis, each rank grids its own subset (gridding is linear over
spokes), and one all_reduce of the partial oversampled k-space grids
completes the adjoint before the cheap, replicated FFT epilogue.  A second
'coil' axis may shard the channels as well; the coil combine then finishes
with the collectives of the frame x coil mesh.

Collectives per frame:
  * adjoint recon: one all_reduce of the (nxos, nxos) coil grids over
    'spoke' (and the coil combine's when coils are sharded);
  * CGNR ("pair" / "transpose"): one such all_reduce per A^H W (.) (the CG
    vectors live in the replicated image domain, so alpha and beta need no
    reduction over 'spoke'; with sharded coils the inner products are summed
    over 'coil' as in `mesh.py`);
  * CGNR --toeplitz: one all_reduce of the Fourier multiplier at setup,
    then iterations with no collective.

The spoke count need not divide the axis: spokes are zero-padded to the mesh
(zero samples grid to zero) and a 0/1 mask weights the padding out of CGNR's
W (``solver.cgnr_radial2d``'s ``sample_mask``).
"""

from __future__ import annotations

import torch

from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.nufft import _adjoint_epilogue, _grid_backend, sdc_weights
from tron_tpu_torch.parallel.distributed import (
    MeshAxis,
    ProcessMesh,
    all_gather_cat,
    psum,
    world_size,
)
from tron_tpu_torch.recon import _combine
from tron_tpu_torch.solver import cgnr_radial2d
from tron_tpu_torch.trajectory import spoke_angles


def make_spoke_mesh(n_spoke: int | None = None, n_coil: int = 1, device=None) -> ProcessMesh:
    """('spoke',) mesh, or ('spoke', 'coil') when n_coil > 1, over the ranks
    of the world.  The mesh covers the world: a process drives one device,
    so there is no rank to leave out (the JAX mesh may take a subset of one
    process's devices)."""
    if n_spoke is None:
        n_spoke = world_size() // n_coil
    if n_coil == 1:
        return ProcessMesh.create(("spoke",), (n_spoke,), device)
    return ProcessMesh.create(("spoke", "coil"), (n_spoke, n_coil), device)


def nufft_adjoint_spoke_sharded(
    d_local: torch.Tensor,
    angles_local: torch.Tensor,
    cfg: ReconConfig,
    npe_total: int,
    axis: MeshAxis | None,
    apply_sdc: bool = True,
) -> torch.Tensor:
    """One shard's adjoint NUFFT: grid this rank's spokes, sum the partial
    oversampled grids over ``axis`` (the mesh's 'spoke' axis; the JAX package
    names it, here the handle carries the process group), run the epilogue.

    d_local: (..., npe_local, nro), this shard's slice of the frame window
    (zero-padded spokes contribute nothing).  The Ram-Lak weights and the
    reference's 1/(nxos*npe) output scale (`src/tron.cu:532`) both use the
    frame's ``npe_total``, so the result equals ``nufft.nufft_adjoint`` of
    the whole window."""
    npe_loc, nro = d_local.shape[-2:]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    if apply_sdc:
        d_local = d_local * sdc_weights(cfg, nro, npe_total, d_local.device).to(d_local.dtype)
    batch = d_local.shape[:-2]
    flat = d_local.reshape((-1,) + tuple(d_local.shape[-2:]))
    kgrid = _grid_backend(cfg, d_local.device)(flat, angles_local, nxos, cfg.kernwidth, beta)
    # the gridder scaled by 1/(nxos * npe_local); rescale to the frame's npe
    kgrid = psum(kgrid * (npe_loc / npe_total), axis)
    return _adjoint_epilogue(kgrid.reshape(tuple(batch) + (nxos, nxos)), n, cfg, beta)


def recon_window_spoke_sharded(
    window: torch.Tensor, cfg: ReconConfig, mesh: ProcessMesh, skip: int = 0
) -> torch.Tensor:
    """One frame window (nc, npe, nro), the same on every rank, reconstructed
    with its spokes sharded over mesh 'spoke' (and its channels over 'coil'
    when the mesh has that axis): the low-latency path for a single (or the
    latest) frame.  Returns, on every rank, the combined image (n, n) per
    cfg.coil_combine ("sos" / "walsh") or the coil images (nc, n, n)
    ("none").  ``skip`` is the window's global profile offset
    (cfg.skip_angles + frame start), as in ``trajectory.spoke_angles``.

    Matches the recon of the whole window: the partial grids sum to the full
    one, and CGNR solves the same weighted least-squares problem (see
    ``solver.cgnr_radial2d``'s ``spoke_axis``)."""
    nc, npe, nro = window.shape
    spoke, coil = mesh.axis("spoke"), mesh.axis("coil")
    if nc % coil.size:
        raise ValueError(f"nc={nc} must divide over coil axis {coil.size}")
    npl = -(-npe // spoke.size)          # spokes per shard
    npad = npl * spoke.size
    scheme = cfg.scheme_for("adjoint")
    dev = window.device
    # linear schemes derive angles from the frame's npe, so the padded angle
    # array is built whole and sliced (golden angles are index-based and
    # simply continue; padded spokes carry zero data and zero CGNR weight)
    if scheme == "golden" or npad == npe:
        angles = spoke_angles(npad, scheme, cfg.skip_angles + skip, device=dev)
    else:
        angles = spoke_angles(npe, scheme, cfg.skip_angles + skip, device=dev)
        angles = torch.cat([angles, angles.new_zeros(npad - npe)])
    mask = (torch.arange(npad, device=dev) < npe).to(torch.float32)
    if npad != npe:
        window = torch.cat([window, window.new_zeros((nc, npad - npe, nro))], dim=1)
    ncl = nc // coil.size
    mine = slice(spoke.index * npl, (spoke.index + 1) * npl)
    d_local = window[coil.index * ncl : (coil.index + 1) * ncl, mine]
    if cfg.niter > 0:
        coilimg = cgnr_radial2d(
            d_local, angles[mine], cfg,
            spoke_axis=spoke, npe_total=npe, sample_mask=mask[mine],
            reduce_axes=(coil,) if coil.size > 1 else (),
        )
    else:
        coilimg = nufft_adjoint_spoke_sharded(d_local, angles[mine], cfg, npe, spoke)
    if cfg.coil_combine == "none":
        return all_gather_cat(coilimg, coil, dim=0)
    return _combine(coilimg, cfg, coil)
