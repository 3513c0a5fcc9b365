"""Adjoint gridding on the card (counterpart of `tron_tpu/ops/grid_pallas.py`).

The wrappers here launch the hand-written kernel of
`csrc/grid_radial2d.cu`, which replaces the Pallas kernels `_win_kernel`
(in its integer-radius and its exact-lattice modes) and `_grid_kernel`.  A
CUDA tensor launches the kernel or raises; a CPU tensor takes the kernel's
plain version (`ops/grid.py`), and only because it lies on the CPU.  A
kernel failure is never caught to fall back.

``LAUNCHES`` counts kernel launches (one per wrapper call that reached the
card), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from tron_tpu_torch import _build
from tron_tpu_torch.ops.degrid import lattice_radii
from tron_tpu_torch.ops.grid import _radius_map, drop_readout0, grid_radial2d_planes_plain
from tron_tpu_torch.ops.grid import grid_radial2d as grid_radial2d_plain

LAUNCHES = 0

# Precision classes of the JAX gridder.  They exist for the TPU's bf16 MXU;
# the CUDA kernel runs fp32 FMA for every one of them.
MATMUL_DTYPES = ("bfloat16", "bf16x2", "bf16x3", "float32")


def _planes(ds: torch.Tensor) -> torch.Tensor:
    """(..., C, npe, nR) complex -> (..., npe, nR, 2C) f32, channel 2c
    holding coil c's real part and 2c+1 its imaginary part."""
    *batch, C, npe, nR = ds.shape
    s2 = torch.stack([ds.real, ds.imag], dim=-3)       # (..., C, 2, npe, nR)
    s2 = s2.reshape(tuple(batch) + (2 * C, npe, nR))
    return torch.movedim(s2, -3, -1).to(torch.float32).contiguous()


def to_sample_planes(data: torch.Tensor, nxos: int) -> torch.Tensor:
    """(..., C, npe, nro) complex -> (..., npe, nxos, 2C) f32 sample planes.

    The once-per-acquisition half of the gridder's sample prep: radius
    resample + edge mask + the complex -> real-plane relayout.  Density
    compensation must be applied to ``data`` beforehand.
    """
    nro = data.shape[-1]
    _, ridx, valid = _radius_map(nxos, nro, data.device)
    if nro == nxos:
        ds = data * valid.to(data.dtype)
    else:
        ds = torch.index_select(data, -1, ridx) * valid.to(data.dtype)
    return _planes(ds)


def _check_planes(
    planes: torch.Tensor, angles: torch.Tensor, nxos: int, exact: bool = False
) -> None:
    if planes.dim() != 3 or planes.dtype != torch.float32:
        raise ValueError(
            f"planes must be (npe, nR, 2C) float32, got {tuple(planes.shape)} "
            f"{planes.dtype}"
        )
    npe, nR, K = planes.shape
    if (nR < 2 if exact else nR != nxos) or K == 0 or K % 2 or npe == 0:
        rows = "nR >= 2 readout rows" if exact else f"nxos={nxos} rows"
        raise ValueError(
            f"planes shape {tuple(planes.shape)} does not fit: need npe >= 1 spokes, "
            f"{rows}, an even channel count >= 2"
        )
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    if angles.shape != (npe,) or angles.dtype != torch.float32:
        raise ValueError(
            f"angles must be ({npe},) float32, got {tuple(angles.shape)} {angles.dtype}"
        )
    if angles.device != planes.device:
        raise ValueError(f"angles on {angles.device}, planes on {planes.device}")


def grid_radial2d_planes(
    planes: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    matmul_dtype: str = "float32",
) -> torch.Tensor:
    """Adjoint gridding from sample planes (npe, nxos, 2C) f32 (see
    to_sample_planes).  Returns (C, nxos, nxos) complex64 scaled by
    1/(nxos*npe).  ``matmul_dtype`` names the JAX precision class; the
    kernel computes in fp32 for every class."""
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be one of {MATMUL_DTYPES}")
    if planes.device.type == "cpu":
        return grid_radial2d_planes_plain(planes, angles, nxos, kernwidth, beta)
    if planes.device.type != "cuda":
        raise ValueError(f"no gridding kernel for device {planes.device}")
    _check_planes(planes, angles, nxos)
    return _launch(planes, angles, nxos, kernwidth, beta, None)


def _launch(planes, angles, nxos, kernwidth, beta, rad) -> torch.Tensor:
    """rad None: integer radii (nR == nxos); else the (nR,) row radii."""
    global LAUNCHES
    built = _build.load()
    npe, nR, K = planes.shape
    ct = torch.cos(angles)
    st = torch.sin(angles)
    out = torch.empty((K // 2, nxos, nxos), dtype=torch.complex64, device=planes.device)
    with torch.cuda.device(planes.device):
        code = built.lib.tron_grid_radial2d_planes(
            planes.data_ptr(), ct.data_ptr(), st.data_ptr(),
            None if rad is None else rad.data_ptr(), out.data_ptr(),
            npe, nR, nxos, K, float(kernwidth), float(beta), 1.0 / (nxos * npe),
            torch.cuda.current_stream(planes.device).cuda_stream,
        )
    _build.check(built.lib, code, "grid_radial2d kernel")
    LAUNCHES += 1
    return out


def grid_radial2d(
    data: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    matmul_dtype: str = "float32",
    pe_chunk: int = 8,
) -> torch.Tensor:
    """Adjoint gridding, complex in and out (counterpart of
    ``grid_radial2d_pallas``).  data: (C, npe, nro) or (npe, nro) complex;
    returns (C, nxos, nxos) (or (nxos, nxos)) complex64.  ``pe_chunk``
    steps the plain version only."""
    if data.dim() == 2:
        return grid_radial2d(
            data[None], angles, nxos, kernwidth, beta, matmul_dtype, pe_chunk
        )[0]
    if data.device.type == "cpu":
        if matmul_dtype not in MATMUL_DTYPES:
            raise ValueError(f"matmul_dtype must be one of {MATMUL_DTYPES}")
        return grid_radial2d_plain(data, angles, nxos, kernwidth, beta, pe_chunk=pe_chunk)
    return grid_radial2d_planes(
        to_sample_planes(data, nxos), angles, nxos, kernwidth, beta, matmul_dtype
    )


def grid_radial2d_exact(
    data: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    matmul_dtype: str = "float32",
    pe_chunk: int = 8,
) -> torch.Tensor:
    """Exact-lattice adjoint gridding (counterpart of
    ``grid_radial2d_pallas_exact``): every readout u grids at its exact
    radius (u/nro - 1/2) * nxos instead of the trunc-resample onto integer
    radii (`src/tron.cu:517`), which makes it the transpose of the
    degridding kernel at any gridos.  Readout 0 is never gridded.  data:
    (C, npe, nro) complex; returns (C, nxos, nxos) complex64 scaled by
    1/(nxos*npe)."""
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be one of {MATMUL_DTYPES}")
    nro = data.shape[-1]
    if data.device.type == "cpu":
        return grid_radial2d_plain(
            drop_readout0(data), angles, nxos, kernwidth, beta, pe_chunk=pe_chunk,
            raw_rows=True,
        )
    if data.device.type != "cuda":
        raise ValueError(f"no gridding kernel for device {data.device}")
    if data.dim() != 3:
        raise ValueError(f"data must be (C, npe, nro), got {tuple(data.shape)}")
    planes = _planes(data)
    _check_planes(planes, angles, nxos, exact=True)
    return _launch(
        planes, angles, nxos, kernwidth, beta, lattice_radii(nro, nxos, data.device)
    )
