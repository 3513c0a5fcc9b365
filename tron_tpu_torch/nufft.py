"""NUFFT operator pipelines (counterpart of `tron_tpu/nufft.py`):

  adjoint  (`src/tron.cu:623-637`):
      precompensate -> grid -> centered unnormalized IFFT -> crop -> deapod
  forward  (`src/tron.cu:639-649`):
      pad -> deapod -> centered FFT -> degrid

Radial data is (..., npe, nro); images are (..., n, n) with n = nro // 2
(adjoint) and k-space grids (nxos, nxos), nxos = n * gridos.  The
degridding kernel wraps or clips by an argument and takes any grid; the
JAX package's wrap-edge patch `_patch_degrid_wrap_edges` has its
counterpart in the degridding wrapper, which computes those readouts at
float32 at the bf16x2 and bf16x3 classes (`ops/degrid.fp32_wrap_edges`).
"""

from __future__ import annotations

import functools

import torch

from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.ops import degrid_cuda, grid_cuda
from tron_tpu_torch.ops.degrid import degrid_radial2d
from tron_tpu_torch.ops.fftops import (
    centered_fft2,
    centered_ifft2_unnormalized,
    crop_center,
    deapodize,
    pad_center,
)
from tron_tpu_torch.ops.grid import drop_readout0, grid_radial2d
from tron_tpu_torch.trajectory import ideal_sdc, ramlak_sdc


def sdc_weights(cfg: ReconConfig, nro: int, npe: int, device=None) -> torch.Tensor:
    """Density-compensation weights per cfg.sdc."""
    if cfg.sdc == "ideal":
        return ideal_sdc(nro, npe, device)
    return ramlak_sdc(nro, npe, device)


def _kernel_backend(cfg: ReconConfig, device: torch.device) -> bool:
    """True when gridding and degridding go through the kernel wrappers of
    grid_cuda and degrid_cuda (which take the plain version for a CPU
    tensor); raises for backend="pallas" on a tensor that is not on the
    card."""
    if cfg.backend == "jnp":
        return False
    if cfg.backend == "pallas" and device.type != "cuda":
        raise ValueError(f"backend='pallas' needs a CUDA tensor, got one on {device}")
    if cfg.backend not in ("pallas", "auto"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return True


def kernel_class(cfg: ReconConfig, device: torch.device) -> str:
    """The precision class the kernel wrappers get on ``device``: on the
    card ``cfg.matmul_dtype``, as JAX's kernels take it on the TPU; on the
    CPU "float32", since JAX's "auto" backend off the TPU runs its jnp
    gridder and degridder, which have no class (`tron_tpu/nufft.py:65-78`,
    `:147-165`), so the port's CPU path stays JAX's."""
    return cfg.matmul_dtype if device.type == "cuda" else "float32"


def _grid_backend(cfg: ReconConfig, device: torch.device):
    if _kernel_backend(cfg, device):
        return functools.partial(
            grid_cuda.grid_radial2d, matmul_dtype=kernel_class(cfg, device),
            pe_chunk=cfg.pe_chunk, tuning=cfg.kernel_tuning(),
        )
    return functools.partial(grid_radial2d, pe_chunk=cfg.pe_chunk)


def nufft_adjoint(
    data: torch.Tensor,
    angles: torch.Tensor,
    cfg: ReconConfig,
    apply_sdc: bool = True,
) -> torch.Tensor:
    """Radial samples (..., npe, nro) complex -> coil images (..., n, n)."""
    npe, nro = data.shape[-2:]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)

    if apply_sdc:
        data = data * sdc_weights(cfg, nro, npe, data.device).to(data.dtype)
    # flatten batch dims onto one channel axis (the kernel is 3-D)
    batch = data.shape[:-2]
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))
    kgrid = _grid_backend(cfg, data.device)(flat, angles, nxos, cfg.kernwidth, beta)
    kgrid = kgrid.reshape(tuple(batch) + (nxos, nxos))
    return _adjoint_epilogue(kgrid, n, cfg, beta)


def _adjoint_epilogue(kgrid: torch.Tensor, n: int, cfg: ReconConfig, beta: float):
    """Centered unnormalized IFFT + crop + deapod."""
    nxos = kgrid.shape[-1]
    img = centered_ifft2_unnormalized(kgrid)
    img = crop_center(img, n)
    if cfg.deapodize:
        img = deapodize(img, nxos, cfg.kernwidth, beta)
    return img


def nufft_adjoint_exact(
    data: torch.Tensor, angles: torch.Tensor, cfg: ReconConfig
) -> torch.Tensor:
    """Exact-lattice adjoint: grids every readout at its exact radius
    instead of the reference's trunc-resample (`src/tron.cu:517`), making
    it the adjoint of the forward degrid at any gridos (the A^H of the CGNR
    operator pair when gridos != 2).  No SDC is applied (the solver supplies
    its own weights).  Readout 0 is never gridded.  Radial samples (...,
    npe, nro) -> coil images (..., n, n)."""
    data = drop_readout0(data)
    npe, nro = data.shape[-2:]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    batch = data.shape[:-2]
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))
    if _kernel_backend(cfg, data.device):
        kgrid = grid_cuda.grid_radial2d_exact(
            flat, angles, nxos, cfg.kernwidth, beta,
            matmul_dtype=kernel_class(cfg, data.device), pe_chunk=cfg.pe_chunk,
            tuning=cfg.kernel_tuning(),
        )
    else:
        kgrid = grid_radial2d(
            flat, angles, nxos, cfg.kernwidth, beta, pe_chunk=cfg.pe_chunk, raw_rows=True
        )
    kgrid = kgrid.reshape(tuple(batch) + (nxos, nxos))
    return _adjoint_epilogue(kgrid, n, cfg, beta)


def nufft_forward(
    img: torch.Tensor,
    angles: torch.Tensor,
    cfg: ReconConfig,
    nro: int | None = None,
    wrap: bool = True,
) -> torch.Tensor:
    """Images (..., n, n) -> radial samples (..., npe, nro).

    nro defaults to gridos * n (`src/tron.cu:945`).  ``wrap=True``
    reproduces the reference's periodic domain (`src/tron.cu:569-570`);
    ``wrap=False`` clips KB footprints at the grid edge (the exact
    transpose of the gridding adjoint).  The degridding kernel does either
    itself; under wrap at bf16x2 and bf16x3 the wrap-edge readouts come out
    float32, as JAX's patch makes them."""
    n = img.shape[-1]
    nxos = int(n * cfg.gridos)
    if nro is None:
        nro = nxos
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    x = pad_center(img, nxos)
    if cfg.deapodize:
        x = deapodize(x, nxos, cfg.kernwidth, beta)
    kgrid = centered_fft2(x)
    if not _kernel_backend(cfg, img.device):
        return degrid_radial2d(kgrid, angles, nro, cfg.kernwidth, beta, wrap=wrap)
    batch = kgrid.shape[:-2]
    flat = kgrid.reshape((-1,) + tuple(kgrid.shape[-2:]))
    out = degrid_cuda.degrid_radial2d(
        flat, angles, nro, cfg.kernwidth, beta, matmul_dtype=kernel_class(cfg, img.device),
        wrap=wrap, tuning=cfg.kernel_tuning(),
    )
    return out.reshape(tuple(batch) + tuple(out.shape[-2:]))


def planes_path_ok(cfg: ReconConfig) -> bool:
    """True when the hoisted sample-plane path applies: the kernel backends.
    A gather has no tiling constraint, so every CUDA tensor qualifies; a CPU
    tensor runs the same path with the kernel's plain version."""
    return cfg.backend in ("pallas", "auto")


def nufft_adjoint_planes(
    planes: torch.Tensor, angles: torch.Tensor, cfg: ReconConfig
) -> torch.Tensor:
    """Adjoint recon from pre-transformed sample planes (npe, nR, 2C) f32
    (see ops.grid_cuda.to_sample_planes; SDC, radius map and mask applied
    upstream, once per acquisition).  Returns coil images (C, n, n)."""
    _kernel_backend(cfg, planes.device)
    nxos = planes.shape[-2]
    n = int(round(nxos / cfg.gridos))
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    kgrid = grid_cuda.grid_radial2d_planes(
        planes, angles, nxos, cfg.kernwidth, beta,
        matmul_dtype=kernel_class(cfg, planes.device), tuning=cfg.kernel_tuning(),
    )
    return _adjoint_epilogue(kgrid, n, cfg, beta)
