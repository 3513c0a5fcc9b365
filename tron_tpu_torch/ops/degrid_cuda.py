"""Forward degridding on the card (counterpart of
`tron_tpu/ops/degrid_pallas.py`).

The wrapper here launches the hand-written kernel of
`csrc/degrid_radial2d.cu`, which replaces the Pallas kernel
`_degrid_kernel`.  A CUDA tensor launches the kernel or raises; a CPU tensor
takes the kernel's plain version (`ops/degrid.py`), and only because it lies
on the CPU.  A kernel failure is never caught to fall back.

The kernel takes any grid size and any readout count and does the periodic
wrap itself, so the JAX package's dense fallback for untileable grids has
no counterpart; the class that fallback computes does (`degridder_class`).
So does its wrap-edge patch (`nufft._patch_degrid_wrap_edges`), which
recomputes the readouts whose footprint can cross the grid edge at float32
at the bf16x2 and bf16x3 classes: a second launch of the float32 kernel on
the same grid planes with only those readouts' radii, copied over the
class's values (`ops/degrid.fp32_wrap_edges`, the rule of the plain
version too).

``LAUNCHES`` counts kernel launches (one per wrapper call that reached the
card, two where the wrap edges are recomputed), so a run can show that its
main path went through the kernel; ``reset_launches()`` zeroes it.
"""

from __future__ import annotations

import functools

import torch

from tron_tpu_torch import _build
from tron_tpu_torch.ops.degrid import degrid_radial2d as degrid_radial2d_plain
from tron_tpu_torch.ops.degrid import fp32_wrap_edges, lattice_radii, wrap_edge_readouts
from tron_tpu_torch.ops.precision import MATMUL_DTYPES
from tron_tpu_torch.ops.precision import check as _check_dtype
from tron_tpu_torch.tracing import span

LAUNCHES = 0

# Neighbours per axis the kernel holds, int(2*kernwidth) + 1: the gridding
# kernels' range (kernwidth < grid_cuda.MAX_KERNWIDTH).  Up to 8 run the
# narrow instantiation, 9 to 14 the wide one (csrc/degrid_radial2d.cu).
MAX_OFF = 14
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def to_grid_planes(kgrid: torch.Tensor) -> torch.Tensor:
    """(C, n, n) complex -> (n, n, 2C) f32 grid planes, channel 2c holding
    coil c's real part and 2c+1 its imaginary part: one neighbour of a
    sample is then one contiguous run of 2C floats."""
    C, n, _ = kgrid.shape
    g = torch.view_as_real(kgrid.to(torch.complex64))      # (C, n, n, 2)
    return g.permute(1, 2, 0, 3).reshape(n, n, 2 * C).contiguous()


def _check(kgrid: torch.Tensor, angles: torch.Tensor, nro: int, kernwidth: float) -> None:
    if kgrid.dim() != 3 or kgrid.dtype != torch.complex64:
        raise ValueError(
            f"kgrid must be (C, n, n) complex64, got {tuple(kgrid.shape)} {kgrid.dtype}"
        )
    C, ny, n = kgrid.shape
    if ny != n or C == 0 or n == 0:
        raise ValueError(f"kgrid shape {tuple(kgrid.shape)} is not C >= 1 square grids")
    if angles.dim() != 1 or angles.dtype != torch.float32 or angles.numel() == 0:
        raise ValueError(
            f"angles must be (npe,) float32 with npe >= 1, got {tuple(angles.shape)} "
            f"{angles.dtype}"
        )
    if angles.device != kgrid.device:
        raise ValueError(f"angles on {angles.device}, kgrid on {kgrid.device}")
    if nro < 1:
        raise ValueError(f"nro must be >= 1, got {nro}")
    if not 1 <= int(2 * kernwidth) + 1 <= MAX_OFF:
        raise ValueError(
            f"kernwidth {kernwidth} needs {int(2 * kernwidth) + 1} neighbours per axis; "
            f"the kernel holds 1 to {MAX_OFF} (kernwidth < {MAX_OFF / 2})"
        )
    if angles.numel() * nro > _INT_MAX or n * n * 2 * C > _INT_MAX:
        raise ValueError("npe*nro and n*n*2C must each fit a 32-bit int")


def degridder_class(n: int, nro: int, matmul_dtype: str) -> str:
    """The class the degridding kernel computes for JAX's degridder called
    at ``matmul_dtype``, by JAX's dispatch: a grid that does not tile into
    two or more 128-pixel tiles, or an odd ``nro``, goes to the dense XLA
    degridder in fp32 whatever the class (`degrid_pallas.py:319-325`), and
    `nufft_forward` sends an odd ``nro`` to its fp32 gather
    (`tron_tpu/nufft.py:283`); any other shape runs `_degrid_kernel` at the
    class."""
    _check_dtype(matmul_dtype)
    if nro % 2 or n % 128 or n // 128 < 2:
        return "float32"
    return matmul_dtype


def degrid_radial2d(
    kgrid: torch.Tensor,
    angles: torch.Tensor,
    nro: int,
    kernwidth: float,
    beta: float,
    matmul_dtype: str = "float32",
    wrap: bool = True,
    tuning=None,
) -> torch.Tensor:
    """Forward degridding (counterpart of ``degrid_radial2d_pallas``, with
    the wrap that the Pallas kernel leaves to a patch): kgrid (C, n, n) or
    (n, n) complex -> samples (C, npe, nro) (or (npe, nro)) complex64.
    ``matmul_dtype`` is the JAX precision class, computed by the kernel (and
    by the plain version on a CPU tensor) as `_degrid_kernel` computes it
    (`ops/degrid.py`), on the shapes `degridder_class` gives it; others
    compute float32.  With ``wrap`` at bf16x2 and bf16x3 the wrap-edge
    readouts are float32, as JAX's patch makes them (a second launch; the
    module's docstring).  ``tuning.batched`` launches the same kernel: the
    Pallas kernel's batched mode is a static unroll over its neighbours
    (`degrid_pallas.py:148-174`), and the CUDA kernel unrolls each
    neighbour row's noff columns statically already."""
    if kgrid.dim() == 2:
        return degrid_radial2d(
            kgrid[None], angles, nro, kernwidth, beta, matmul_dtype, wrap, tuning
        )[0]
    n = kgrid.shape[-1]
    matmul_dtype = degridder_class(n, nro, matmul_dtype)
    if kgrid.device.type == "cpu":
        return degrid_radial2d_plain(
            kgrid, angles, nro, kernwidth, beta, wrap=wrap, matmul_dtype=matmul_dtype
        )
    if kgrid.device.type != "cuda":
        raise ValueError(f"no degridding kernel for device {kgrid.device}")
    _check(kgrid, angles, nro, kernwidth)
    gplanes = to_grid_planes(kgrid)
    ct, st = torch.cos(angles), torch.sin(angles)
    out = _launch(gplanes, ct, st, lattice_radii(nro, n, kgrid.device), kernwidth, beta, wrap,
                  matmul_dtype)
    if fp32_wrap_edges(matmul_dtype, wrap):
        idx, rad = _edge_tables(nro, n, kernwidth, kgrid.device)
        out.index_copy_(-1, idx, _launch(gplanes, ct, st, rad, kernwidth, beta, wrap, "float32"))
    return out


@functools.cache
def _edge_tables(nro: int, n: int, kernwidth: float, device: torch.device):
    """The wrap-edge readouts (`wrap_edge_readouts`) and their radii, on
    ``device``, cached per geometry.  Read only."""
    idx = wrap_edge_readouts(nro, n, kernwidth)
    return idx.to(device), lattice_radii(nro, n)[idx].to(device)


def _launch(gplanes, ct, st, rad, kernwidth, beta, wrap, matmul_dtype) -> torch.Tensor:
    """One kernel launch: grid planes (n, n, 2C), the spokes' cos and sin
    (npe,) and a radius table (nro,) -> samples (C, npe, nro) complex64.
    The kernel reads a sample's radius only as ``rad[u]``, so a table of
    some readouts' radii gives exactly those readouts."""
    global LAUNCHES
    built = _build.load()
    n, _, K = gplanes.shape
    npe, nro = ct.shape[0], rad.shape[0]
    out = torch.empty((K // 2, npe, nro), dtype=torch.complex64, device=gplanes.device)
    with torch.cuda.device(gplanes.device), span("tron.degrid_radial2d"):
        code = built.lib.tron_degrid_radial2d_planes(
            gplanes.data_ptr(), ct.data_ptr(), st.data_ptr(), rad.data_ptr(),
            out.data_ptr(), npe, nro, n, K, int(2 * kernwidth) + 1, int(bool(wrap)),
            float(kernwidth), float(beta), MATMUL_DTYPES.index(matmul_dtype),
            torch.cuda.current_stream(gplanes.device).cuda_stream,
        )
    _build.check(built.lib, code, "degrid_radial2d kernel")
    LAUNCHES += 1
    return out
