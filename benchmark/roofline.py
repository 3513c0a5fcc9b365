"""The benchmark's frozen yardstick for the kernels' roofline shares: the
least time one H100 could take for a call, the larger of the bytes it must
move (each input read once, each output written once) over the card's
memory rate, and the operations its inputs need over the peak rate of the
units that do them.

Counted from the geometry alone (spokes, readouts, grid size, channels,
the angles and the readouts' radii worked out from them), never from a
kernel's own work items or from the program's tensors.  A frozen copy of
the arithmetic of the port's roofline helpers: the program may change its
copy, the benchmark's stays as it is, and a test holds the two together at
the benchmark's frame shapes.
"""

from __future__ import annotations

import torch

# NVIDIA's data sheet for the H100 SXM part at its 700 W power limit, dense
HBM_BYTES_PER_S = 3.35e12             # device-memory rate
FP32_FLOPS = 67e12                    # fp32 outside the tensor cores
KB_FLOPS = 42                         # one KB weight: 17 FMA (2 each) + sqrt, div, 6 more


def bound(nbytes: float, flops: float, rate: float = FP32_FLOPS) -> tuple[float, str]:
    """max(bytes / memory rate, operations / their peak rate), in ms, and
    which of the two sets it ("bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def support(r: torch.Tensor, c: torch.Tensor, n: int, kww: float) -> torch.Tensor:
    """Grid points X in [-n/2, n-1-n/2] with |r*c - X| < kww, per sample."""
    h = n // 2
    p = r * c
    lo = torch.clamp(torch.floor(p - kww) + 1, min=-h)
    hi = torch.clamp(torch.ceil(p + kww) - 1, max=n - 1 - h)
    return torch.clamp(hi - lo + 1, min=0)


def work_of(radii: torch.Tensor, angles: torch.Tensor, n: int, K: int, kww: float,
            passes: int = 1) -> tuple[float, float]:
    """(term flops, KB flops) that samples at ``radii`` along ``angles``
    need on an n-point grid with K real channels: per sample with terms one
    KB weight per x- and y-neighbour, then per (sample, pixel) term one
    weight product and, per precision-class pass, K channel FMAs."""
    a = angles.double()[:, None]
    cx = support(radii.double()[None, :], torch.cos(a), n, kww)
    cy = support(radii.double()[None, :], torch.sin(a), n, kww)
    live = (cx > 0) & (cy > 0)
    terms = float((cx * cy).sum())
    return terms * (2 * K * passes + 1), KB_FLOPS * float(((cx + cy) * live).sum())


def grid_bound(npe: int, K: int, angles: torch.Tensor, nxos: int,
               kww: float) -> tuple[float, str]:
    """One gridding call on integer radii: sample planes (npe, nxos, K)
    float32 and the angles in, K/2 grids (nxos, nxos) complex64 out; row 0
    (radius -nxos/2) is never gridded."""
    radii = (torch.arange(nxos, dtype=torch.float64) - nxos // 2)[1:]
    nbytes = npe * nxos * K * 4 + npe * 4 + (K // 2) * nxos * nxos * 8
    return bound(nbytes, sum(work_of(radii, angles.cpu(), nxos, K, kww)))


def degrid_bound(npe: int, C: int, angles: torch.Tensor, n: int, nro: int,
                 kww: float) -> tuple[float, str]:
    """One degridding call, clip: C grids (n, n) complex64, the angles and
    the nro readouts' radii (u/nro - 1/2) n (float32, as the program's
    table) in, C x npe x nro complex64 samples out."""
    radii = (torch.arange(nro, dtype=torch.float32) / nro - 0.5) * n
    flops = sum(work_of(radii, angles.cpu(), n, 2 * C, kww))
    nbytes = C * n * n * 8 + npe * 4 + nro * 4 + C * npe * nro * 8
    return bound(nbytes, flops)
