"""Kaiser-Bessel interpolation kernel math (counterpart of
`tron_tpu/kernels/kb.py`).

The Blair rational-polynomial I0 approximation, the beta shape parameter,
the windowed KB kernel and its Fourier transform (`src/tron.cu:304-370`).
Elementwise torch on the input's device; `csrc/grid_radial2d.cu` evaluates
the same `kb_kernel` inside the gridding kernel.
"""

from __future__ import annotations

import math

import torch

# Numerator/denominator coefficients of the Blair & Edwards rational
# approximation to I0(x) for |x| <= 15 (`src/tron.cu:304-321`).
_I0_NUM = (
    0.210580722890567e-22,
    0.380715242345326e-19,
    0.479440257548300e-16,
    0.435125971262668e-13,
    0.300931127112960e-10,
    0.160224679395361e-7,
    0.654858370096785e-5,
    0.202591084143397e-2,
    0.463076284721000e0,
    0.754337328948189e2,
    0.830792541809429e4,
    0.571661130563785e6,
    0.216415572361227e8,
    0.356644482244025e9,
    0.144048298227235e10,
)
_I0_DEN = (1.0, -0.307646912682801e4, 0.347626332405882e7, -0.144048298227235e10)


def besseli0(x: torch.Tensor) -> torch.Tensor:
    """Modified Bessel function I0 via rational polynomial (|x| <= 15)."""
    z = x * x
    num = torch.zeros_like(z) + _I0_NUM[0]
    for c in _I0_NUM[1:]:
        num = num * z + c
    den = torch.zeros_like(z) + _I0_DEN[0]
    for c in _I0_DEN[1:]:
        den = den * z + c
    return -num / den


def kb_beta(kernwidth: float, gridos: float, beatty: bool = False) -> float:
    """KB shape parameter beta (`src/tron.cu:323-335`): 2.34 * J with
    J = 2*kernwidth, or the Beatty et al. 2005 formula with the full width."""
    if beatty:
        a = 2.0 * kernwidth / gridos
        b = gridos - 0.5
        return math.pi * float((a * a * b * b - 0.8) ** 0.5)
    return 2.34 * 2.0 * kernwidth


def kb_kernel(x: torch.Tensor, kernwidth: float, beta: float) -> torch.Tensor:
    """KB window 0.5*I0(beta*sqrt(1-(x/kw)^2))/kw for |x| < kw, else 0
    (`src/tron.cu:338-349`)."""
    r = x * (1.0 / kernwidth)
    inside = torch.abs(r) < 1.0
    f = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    val = (0.5 / kernwidth) * besseli0(beta * f)
    return torch.where(inside, val, torch.zeros_like(val))


def kb_hat(u: torch.Tensor, kernwidth: float, beta: float) -> torch.Tensor:
    """Fourier transform of the KB window (`src/tron.cu:351-370`), with
    u in units of the oversampled FOV; sin(z)/z or sinh(z)/z branches."""
    J = 2.0 * kernwidth
    r = math.pi * J * u
    q = r * r - beta * beta
    az = torch.sqrt(torch.abs(q))
    big = az > 1e-12
    safe = torch.where(big, az, torch.ones_like(az))
    y = torch.where(q > 0, torch.sin(safe) / safe, torch.sinh(safe) / safe)
    return torch.where(big, y, torch.ones_like(y))
