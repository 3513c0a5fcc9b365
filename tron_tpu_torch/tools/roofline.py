"""The least time one H100 could take for the kernels' work: the larger of
the bytes a call must move (each input read once, each output written once)
over the card's memory rate, and the operations its inputs need over the
peak rate of the units that do them.

    from tron_tpu_torch.tools.roofline import grid_bound
    ms, by = grid_bound(planes, angles, nxos)      # by: "bytes" or "operations"

The operations are counted from the data's geometry, not from the most a
call could need: per sample with terms one KB weight per x- and
y-neighbour (``KB_FLOPS``), then per (sample, pixel) term one weight
product and, per precision-class pass, one FMA (2 flops) per real channel.
Each function runs on the device its tensors lie on.
"""

from __future__ import annotations

import torch

from tron_tpu_torch.ops.degrid import lattice_radii

# NVIDIA's data sheet for the H100 SXM part at its 700 W power limit, dense
HBM_BYTES_PER_S = 3.35e12             # device-memory rate
FP32_FLOPS = 67e12                    # fp32 outside the tensor cores
BF16_TC_FLOPS = 989e12                # bf16 on the tensor cores
TF32_TC_FLOPS = 495e12                # TF32 on the tensor cores
KB_FLOPS = 42                         # one kb_weight: 17 FMA (2 each) + sqrt, div, 6 more


def bound(nbytes: float, flops: float, rate: float = FP32_FLOPS) -> tuple[float, str]:
    """max(bytes / memory rate, operations / their peak rate), in ms, and
    which of the two sets it ("bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def support(r: torch.Tensor, c: torch.Tensor, n: int, kww: float = 2.0) -> torch.Tensor:
    """Grid points X in [-n/2, n-1-n/2] with |r*c - X| < kww, per sample."""
    h = n // 2
    p = r * c
    lo = torch.clamp(torch.floor(p - kww) + 1, min=-h)
    hi = torch.clamp(torch.ceil(p + kww) - 1, max=n - 1 - h)
    return torch.clamp(hi - lo + 1, min=0)


def work_of(radii: torch.Tensor, angles: torch.Tensor, n: int, K: int, passes: int = 1,
            kww: float = 2.0) -> tuple[float, float]:
    """(term flops, KB flops) that samples at ``radii`` along ``angles``
    need on an n-point grid with K real channels: per sample with terms,
    one KB per x- and y-neighbour, then per (sample, pixel) term one weight
    product and, per class pass, K channel FMAs (2 flops each)."""
    a = angles.double()[:, None]
    cx = support(radii.double()[None, :], torch.cos(a), n, kww)
    cy = support(radii.double()[None, :], torch.sin(a), n, kww)
    live = (cx > 0) & (cy > 0)
    terms = float((cx * cy).sum())
    return terms * (2 * K * passes + 1), KB_FLOPS * float(((cx + cy) * live).sum())


def grid_bound(planes: torch.Tensor, angles: torch.Tensor, nxos: int, passes: int = 1,
               tc: float | None = None, kww: float = 2.0) -> tuple[float, str]:
    """Gridding on integer radii: planes (npe, nR, 2C) and angles in, C
    grids (nxos, nxos) complex64 out; row 0 is never gridded.  ``tc``: the
    tensor-core rate the term products run at (B5), where the KB weights
    stay on the fp32 units."""
    npe, nR, K = planes.shape
    radii = (torch.arange(nR, device=angles.device, dtype=torch.float64) - nxos // 2)[1:]
    nbytes = planes.numel() * 4 + angles.numel() * 4 + (K // 2) * nxos * nxos * 8
    terms, kb_ops = work_of(radii, angles, nxos, K, passes, kww)
    if tc is None:
        return bound(nbytes, terms + kb_ops)
    return max(bound(nbytes, kb_ops), bound(nbytes, terms, tc))


def degrid_bound(kgrid: torch.Tensor, angles: torch.Tensor, nro: int, passes: int = 1,
                 kww: float = 2.0) -> tuple[float, str]:
    """Degridding, clip: C grids (n, n) complex64 and the angles in (the
    radius table included), C x npe x nro complex64 samples out."""
    C, n, _ = kgrid.shape
    flops = sum(work_of(lattice_radii(nro, n, angles.device), angles, n, 2 * C, passes, kww))
    nbytes = kgrid.numel() * 8 + angles.numel() * 4 + nro * 4 + C * angles.numel() * nro * 8
    return bound(nbytes, flops)
