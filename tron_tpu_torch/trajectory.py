"""Radial trajectory geometry (counterpart of `tron_tpu/trajectory.py`):
spoke angles, Ram-Lak and ideal density compensation, sample radii.

Conventions follow the reference (`src/tron.cu:372-378, 405-416, 505-530`):
a spoke at angle t has direction (cos t, sin t); readout sample ro sits at
signed radius (ro - nro/2) * nxos/nro in oversampled-grid units.

Angles are float32 throughout, as in the JAX package: at whole-body profile
offsets (skip ~ 20,000) one float32 ulp of PHI * (pe + skip) is ~2e-3 rad,
so computing them in another precision would move every spoke.
"""

from __future__ import annotations

import math

import torch

from tron_tpu_torch.config import PHI, AngleScheme

TWO_PI = 2.0 * math.pi


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def modang(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [0, 2*pi) (`src/tron.cu:372-378`).

    ``jnp.mod`` is an exact fmod followed by a sign fix; ``torch.remainder``
    computes a - b*floor(a/b), which is not exact, so it is not used."""
    two_pi = _f32(TWO_PI, x.device)
    y = torch.fmod(x, two_pi)
    return torch.where(y < 0, y + two_pi, y)


def minangulardist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum angular distance treating a and a+pi as equivalent
    (`src/tron.cu:380-388`; defined but unused there)."""
    pi = _f32(math.pi, a.device)
    two_pi = _f32(TWO_PI, a.device)
    d1 = torch.abs(modang(a - b))
    d2 = torch.abs(modang(a + pi) - b)
    d3 = two_pi - d1
    d4 = two_pi - d2
    return torch.minimum(torch.minimum(d1, d2), torch.minimum(d3, d4))


def spoke_angles(
    npe: int,
    scheme: str,
    skip: torch.Tensor | int = 0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Float32 angles of the npe spokes of one frame, on ``device``.

    ``skip`` is the global profile offset (skip_angles + frame offset); only
    the golden-angle scheme depends on it (`src/tron.cu:509`).
    """
    pe = torch.arange(npe, dtype=torch.float32, device=device)
    if scheme == AngleScheme.GOLDEN:
        sk = torch.as_tensor(skip, device=pe.device).to(torch.float32)
        return modang(_f32(PHI, pe.device) * (pe + sk))
    if scheme == AngleScheme.LINEAR_FULL:
        return pe * _f32(TWO_PI / npe, pe.device) + _f32(math.pi * 0.5, pe.device)
    if scheme == AngleScheme.LINEAR_HALF:
        return pe * _f32(math.pi / npe, pe.device)
    raise ValueError(f"unknown angle scheme {scheme!r}")


def spoke_angle_table(npe: int, scheme: str, skips: torch.Tensor) -> torch.Tensor:
    """Float32 angles of the npe spokes of k frames, (k, npe), on skips'
    device: ``skips`` (k,) int64 holds each frame's global profile offset.
    Row i is bitwise ``spoke_angles(npe, scheme, int(skips[i]))``: the same
    float32 operations, broadcast over a (k, 1) skip (a linear scheme's
    one row repeats)."""
    angles = spoke_angles(npe, scheme, skips[:, None], device=skips.device)
    return angles.expand(skips.shape[0], npe)


def ramlak_sdc(nro: int, npe: int, device=None) -> torch.Tensor:
    """Implicit Ram-Lak density compensation along the readout:
    sdc[ro] = a*|ro - nro/2| + b, a = (2 - 2/npe)/nro, b = 1/npe
    (`src/tron.cu:405-416`)."""
    a = (2.0 - 2.0 / npe) / nro
    b = 1.0 / npe
    r = torch.arange(nro, dtype=torch.float32, device=device)
    return a * torch.abs(r - nro // 2) + b


def ideal_sdc(nro: int, npe: int, device=None) -> torch.Tensor:
    """Exact polar cell-area density weights: pi*|r|/npe, and pi/(4*npe) for
    the shared DC cell."""
    r = torch.abs(torch.arange(nro, dtype=torch.float32, device=device) - nro // 2)
    return torch.where(r == 0, math.pi / (4 * npe), math.pi * r / npe).to(torch.float32)


def sample_radii(nro: int, nxos: int, device=None) -> torch.Tensor:
    """Signed sample radius of each readout index, in oversampled grid
    units: ro -> (ro/nro - 1/2) * nxos (`src/tron.cu:554, 560-561`)."""
    ro = torch.arange(nro, dtype=torch.float32, device=device)
    return (ro / nro - 0.5) * nxos


def grid_radius_to_ro(r: torch.Tensor, nro: int, nxos: int) -> torch.Tensor:
    """Readout index holding the sample at integer grid radius r:
    trunc(r*nro/nxos) + nro/2 with C truncation (`src/tron.cu:517`), the
    product in float32; the identity map + nro/2 when nxos == nro."""
    ridx = torch.trunc(r.to(torch.float32) * _f32(nro / nxos, r.device)).to(torch.int32)
    return ridx + nro // 2
