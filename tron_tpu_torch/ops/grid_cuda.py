"""Adjoint gridding on the card (counterpart of `tron_tpu/ops/grid_pallas.py`).

The wrappers here launch one of three hand-written kernels, all with the
contract of `csrc/grid_radial2d.cuh`:

- ``grid_radial2d`` (`csrc/grid_radial2d.cu`): the per-tile contraction
  over load-balanced work items, which replaces the Pallas kernels
  `_win_kernel` (in its integer-radius and its exact-lattice modes) and
  `_grid_kernel`; the default (``windowed=True``).  Its workspace (tile
  lists, item table, partial sums) is allocated here with ``torch.empty``;
- ``grid_radial2d_batched`` (`csrc/grid_radial2d_batched.cu`): the same
  passes and workspace with the contraction a static unroll on tensor
  cores (bf16 ``mma.sync`` at the bf16 classes, 3xTF32 at float32), which
  replaces `_win_kernel_batched`, taken when ``tuning.batched`` is set
  (``KernelTuning(batched=True)``, ``TRON_BATCHED=1``);
- ``grid_seg_radial2d`` (`csrc/grid_seg_radial2d.cu`): the contraction
  over static per-(tile, sign) radius segments and wedge-culled spoke
  lists (`ops/cull.py`), staged by bulk async copies, which replaces
  `_seg_kernel`, taken with ``windowed=False``.

Each kernel computes the precision class ``matmul_dtype`` it is handed, as
its Pallas twin does on the TPU (`ops/precision.py`; `gridder_class` applies
JAX's dispatch rules for B4 and B2).  At a class all three sum the same
nonzero terms; B4 in B1's order, regrouped at item boundaries, B5 as
tensor-core products (split TF32 at float32).

A CUDA tensor launches a kernel or raises; a CPU tensor takes the kernels'
plain version (`ops/grid.py`: the planes gridder, or for ``windowed=False``
the sum over each tile's listed segments), and only because it lies on the
CPU.  A kernel failure is never caught to fall back.

``LAUNCH_COUNTS`` counts launches per kernel (one per wrapper call that
reached the card; a replayed CUDA graph adds the calls it captured,
`graphs.py`), so a run can show which kernel its main path went
through; ``LAUNCHES`` reads their total and ``reset_launches()`` zeroes
them.  Under a profiler each wrapper call is one span, ``tron.<kernel>``
(`tracing.py`), on the card and on the CPU alike.
"""

from __future__ import annotations

import functools

import torch

from tron_tpu_torch import _build
from tron_tpu_torch.ops import cull
from tron_tpu_torch.ops.degrid import lattice_radii
from tron_tpu_torch.ops.grid import (
    _radius_map,
    drop_readout0,
    grid_radial2d_planes_culled,
    grid_radial2d_planes_plain,
)
from tron_tpu_torch.ops.grid import grid_radial2d as grid_radial2d_plain
from tron_tpu_torch.ops.precision import MATMUL_DTYPES, bf16
from tron_tpu_torch.ops.precision import check as _check_dtype
from tron_tpu_torch.tracing import span

KERNELS = ("grid_radial2d", "grid_radial2d_batched", "grid_seg_radial2d")
LAUNCH_COUNTS = dict.fromkeys(KERNELS, 0)
_SPANS = {k: f"tron.{k}" for k in KERNELS}

# The tile kernels' weight windows, floor(2*kernwidth) + 3 pixels per axis,
# take at most 16 lanes each (csrc/grid_tiles.cuh).
MAX_KERNWIDTH = 7.0


def __getattr__(name):
    if name == "LAUNCHES":  # the total over the three kernels
        return sum(LAUNCH_COUNTS.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def _kernel(windowed: bool, tuning) -> str:
    """The kernel a wrapper call is routed to (a key of ``KERNELS``)."""
    if not windowed:
        return "grid_seg_radial2d"
    return "grid_radial2d_batched" if tuning is not None and tuning.batched else "grid_radial2d"


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
    if npe * nR > 2**31 - 1:
        raise ValueError("npe*nR must fit a 32-bit int")
    if angles.shape != (npe,) or angles.dtype != torch.float32:
        raise ValueError(
            f"angles must be ({npe},) float32, got {tuple(angles.shape)} {angles.dtype}"
        )
    if angles.device != planes.device:
        raise ValueError(f"angles on {angles.device}, planes on {planes.device}")


def gridder_class(
    nxos: int, matmul_dtype: str, windowed: bool = True, exact: bool = False
) -> tuple[str, bool]:
    """The class the gridding kernels compute for JAX's gridder called at
    ``matmul_dtype``, and whether the samples are rounded to bfloat16 first,
    by JAX's dispatch (`grid_pallas.py:576-591`):

    - a grid that tiles runs `_win_kernel` / `_win_kernel_batched` at the
      class, or with ``windowed=False`` `_seg_kernel`, which takes bf16x2 as
      bf16x3 (`grid_pallas.py:735-738`);
    - any other grid runs `_grid_kernel`, which at bfloat16 rounds the
      samples to bfloat16 first and runs every other class in fp32
      (`grid_pallas.py:832-833`); on the exact lattice JAX grids it with its
      dense raw-rows gridder, which has no class (`tron_tpu/nufft.py:147-165`).
    """
    _check_dtype(matmul_dtype)
    if nxos % 128 == 0 and nxos // 128 >= 2:  # at least two 128-pixel tiles
        if not windowed and matmul_dtype == "bf16x2":
            return "bf16x3", False
        return matmul_dtype, False
    if matmul_dtype == "bfloat16" and not exact:
        return "bfloat16", True
    return "float32", False


def grid_radial2d_planes(
    planes: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    matmul_dtype: str = "float32",
    windowed: bool = True,
    tuning=None,
) -> torch.Tensor:
    """Adjoint gridding from sample planes (npe, nxos, 2C) f32 (see
    to_sample_planes).  Returns (C, nxos, nxos) complex64 scaled by
    1/(nxos*npe).  ``matmul_dtype`` is the JAX precision class, computed as
    `gridder_class` says.  ``windowed=False`` takes the segmented kernel
    (B4); ``tuning.batched`` the tensor-core one (B5)."""
    name = _kernel(windowed, tuning)
    with span(_SPANS[name]):
        cls, round_samples = gridder_class(nxos, matmul_dtype, windowed)
        if planes.device.type == "cpu":
            if round_samples:
                planes = bf16(planes)
            if not windowed:
                return grid_radial2d_planes_culled(planes, angles, nxos, kernwidth, beta,
                                                   matmul_dtype=cls)
            return grid_radial2d_planes_plain(planes, angles, nxos, kernwidth, beta,
                                              matmul_dtype=cls)
        if planes.device.type != "cuda":
            raise ValueError(f"no gridding kernel for device {planes.device}")
        _check_planes(planes, angles, nxos)
        if round_samples:
            planes = bf16(planes)
        return _launch(planes, angles, nxos, kernwidth, beta, None, windowed, tuning, cls)


@functools.cache
def _workspace_bytes(lib, entry: str, *shapes) -> int:
    """Bytes of a tile kernel's workspace for these shapes, from its C entry
    ``entry`` (the C side lays it out)."""
    return int(getattr(lib, entry)(*shapes))


@functools.cache
def _segments(nxos: int, kernwidth: float, nR: int | None, device) -> tuple[torch.Tensor, int]:
    """B4's static segment starts as the kernel reads them, (2T,) int32 on
    ``device`` (sign 0 positive radii, 1 negative; -1 for an empty band),
    and the segment length; built once per geometry."""
    starts, nonempty, seg = cull.tile_segments(nxos, kernwidth, nR)
    flat = torch.from_numpy(starts.astype("int64"))
    flat[~torch.from_numpy(nonempty)] = -1
    return flat.reshape(-1).to(torch.int32).to(device), seg


def _launch(
    planes, angles, nxos, kernwidth, beta, rad, windowed, tuning, cls="float32"
) -> torch.Tensor:
    """rad None: integer radii (nR == nxos); else the (nR,) row radii; cls
    the class the kernel computes."""
    if kernwidth >= MAX_KERNWIDTH:
        raise ValueError(f"the gridding kernels take kernwidth < {MAX_KERNWIDTH}, got {kernwidth}")
    built = _build.load()
    lib = built.lib
    npe, nR, K = planes.shape
    kw = float(kernwidth)
    ct = torch.cos(angles)
    st = torch.sin(angles)
    out = torch.empty((K // 2, nxos, nxos), dtype=torch.complex64, device=planes.device)
    args = (
        planes.data_ptr(), ct.data_ptr(), st.data_ptr(),
        None if rad is None else rad.data_ptr(), out.data_ptr(),
        npe, nR, nxos, K, kw, float(beta), 1.0 / (nxos * npe),
    )
    code = MATMUL_DTYPES.index(cls)
    name = _kernel(windowed, tuning)
    fn = getattr(lib, f"tron_{name}_planes")
    if name == "grid_seg_radial2d":
        lattice = None if rad is None else nR
        starts, seg = _segments(nxos, kw, lattice, planes.device)
        if seg > 128:
            raise ValueError(
                f"the segmented gridding kernel takes segments of at most 128 rows; this "
                f"geometry (nxos {nxos}, {nR} rows, kernwidth {kw}) has {seg}"
            )
        slots = cull.seg_slots(npe, nxos, kw, lattice)
        nbytes = _workspace_bytes(lib, "tron_grid_seg_radial2d_workspace_bytes", npe, nR,
                                  nxos, K, kw, slots)
        extra = (starts.data_ptr(), seg, cull.wedge_margin(kw), slots, code)
    else:
        nbytes = _workspace_bytes(lib, "tron_grid_radial2d_workspace_bytes", npe, nR, nxos, K,
                                  kw)
        extra = (code,)
    work = torch.empty(int(nbytes), dtype=torch.uint8, device=planes.device)
    with torch.cuda.device(planes.device):
        code = fn(*args, *extra, work.data_ptr(), work.numel(),
                  torch.cuda.current_stream(planes.device).cuda_stream)
    _build.check(lib, code, f"{name} kernel")
    LAUNCH_COUNTS[name] += 1
    return out


def grid_radial2d(
    data: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    matmul_dtype: str = "float32",
    pe_chunk: int = 8,
    windowed: bool = True,
    tuning=None,
) -> torch.Tensor:
    """Adjoint gridding, complex in and out (counterpart of
    ``grid_radial2d_pallas``).  data: (C, npe, nro) or (npe, nro) complex;
    returns (C, nxos, nxos) (or (nxos, nxos)) complex64.  ``pe_chunk``
    steps the plain version only."""
    if data.dim() == 2:
        return grid_radial2d(
            data[None], angles, nxos, kernwidth, beta, matmul_dtype, pe_chunk, windowed,
            tuning,
        )[0]
    if data.device.type == "cpu" and windowed:
        cls, round_samples = gridder_class(nxos, matmul_dtype)
        return grid_radial2d_plain(
            bf16(data) if round_samples else data, angles, nxos, kernwidth, beta,
            pe_chunk=pe_chunk, matmul_dtype=cls,
        )
    return grid_radial2d_planes(
        to_sample_planes(data, nxos), angles, nxos, kernwidth, beta, matmul_dtype,
        windowed, tuning,
    )


def grid_radial2d_exact(
    data: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    matmul_dtype: str = "float32",
    pe_chunk: int = 8,
    windowed: bool = True,
    tuning=None,
) -> torch.Tensor:
    """Exact-lattice adjoint gridding (counterpart of
    ``grid_radial2d_pallas_exact``): every readout u grids at its exact
    radius (u/nro - 1/2) * nxos instead of the trunc-resample onto integer
    radii (`src/tron.cu:517`), which makes it the transpose of the
    degridding kernel at any gridos.  Readout 0 is never gridded.  data:
    (C, npe, nro) complex; returns (C, nxos, nxos) complex64 scaled by
    1/(nxos*npe), at the class `gridder_class` gives the exact lattice."""
    name = _kernel(windowed, tuning)
    with span(_SPANS[name]):
        cls, _ = gridder_class(nxos, matmul_dtype, windowed, exact=True)
        nro = data.shape[-1]
        if data.device.type == "cpu" and windowed:
            return grid_radial2d_plain(
                drop_readout0(data), angles, nxos, kernwidth, beta, pe_chunk=pe_chunk,
                raw_rows=True, matmul_dtype=cls,
            )
        if data.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no gridding kernel for device {data.device}")
        if data.dim() != 3:
            raise ValueError(f"data must be (C, npe, nro), got {tuple(data.shape)}")
        planes = _planes(data)
        rad = lattice_radii(nro, nxos, data.device)
        if data.device.type == "cpu":
            return grid_radial2d_planes_culled(planes, angles, nxos, kernwidth, beta, rad=rad,
                                               matmul_dtype=cls)
        _check_planes(planes, angles, nxos, exact=True)
        return _launch(planes, angles, nxos, kernwidth, beta, rad, windowed, tuning, cls)
