"""Analytic Shepp-Logan phantom: image-domain rasterization and exact
continuous k-space.

The reference ships `data/shepplogan.ra` (a 256^2 complex64 image) via
git-lfs; this module synthesizes the same class of fixture analytically so
the test/benchmark pipelines are self-contained (SURVEY.md §2.5).  The
analytic Fourier transform of the ellipse set additionally provides an
*exact continuous* oracle for radial k-space data, independent of any
gridding code.

A copy of `tron_tpu/phantom.py`, which is numpy only: importing it would
import JAX through `tron_tpu/__init__.py`, and the card has no JAX.
"""

from __future__ import annotations

import numpy as np

# Modified (Toft) Shepp-Logan ellipses: (amplitude, a, b, x0, y0, phi_deg)
# in the [-1, 1]^2 field of view.
SHEPP_LOGAN_ELLIPSES = np.array(
    [
        [1.00, 0.6900, 0.9200, 0.00, 0.0000, 0.0],
        [-0.80, 0.6624, 0.8740, 0.00, -0.0184, 0.0],
        [-0.20, 0.1100, 0.3100, 0.22, 0.0000, -18.0],
        [-0.20, 0.1600, 0.4100, -0.22, 0.0000, 18.0],
        [0.10, 0.2100, 0.2500, 0.00, 0.3500, 0.0],
        [0.10, 0.0460, 0.0460, 0.00, 0.1000, 0.0],
        [0.10, 0.0460, 0.0460, 0.00, -0.1000, 0.0],
        [0.10, 0.0460, 0.0230, -0.08, -0.6050, 0.0],
        [0.10, 0.0230, 0.0230, 0.00, -0.6060, 0.0],
        [0.10, 0.0230, 0.0460, 0.06, -0.6050, 0.0],
    ]
)


def shepp_logan(n: int, dtype=np.complex64) -> np.ndarray:
    """Rasterize the phantom as an (n, n) image, indexed [y, x], centered at
    pixel (n//2, n//2) to match the centered-FFT convention of the pipelines."""
    c = np.arange(n) - n // 2
    x = c[None, :] / (n / 2)
    y = c[:, None] / (n / 2)
    img = np.zeros((n, n), dtype=np.float64)
    for amp, a, b, x0, y0, phi in SHEPP_LOGAN_ELLIPSES:
        t = np.deg2rad(phi)
        xr = (x - x0) * np.cos(t) + (y - y0) * np.sin(t)
        yr = -(x - x0) * np.sin(t) + (y - y0) * np.cos(t)
        img += amp * ((xr / a) ** 2 + (yr / b) ** 2 <= 1.0)
    return img.astype(dtype)


def _jinc(z: np.ndarray) -> np.ndarray:
    """J1(2*pi*z)/z with the z->0 limit pi (so jinc(0) = area factor)."""
    from scipy.special import j1

    out = np.full(z.shape, np.pi, dtype=np.float64)
    nz = np.abs(z) > 1e-12
    out[nz] = j1(2.0 * np.pi * z[nz]) / z[nz]
    return out


def shepp_logan_kspace(kx: np.ndarray, ky: np.ndarray, n: int) -> np.ndarray:
    """Exact continuous FT of the phantom at frequencies given in *cycles per
    oversampled-grid sample*: (kx, ky) are the same grid-unit coordinates the
    degridder uses (integer radii = FFT bins of an nxos grid).

    Continuous model: image over [-1,1]^2 sampled on an n-grid; frequency in
    image units is (kx, ky) * (n/2) / nxos ... — callers pass grid-unit
    frequencies and the field-of-view scaling is handled here via ``n``
    (the *original* image size; frequencies are cycles across the n-sample
    FOV when nxos == gridos*n and radii are in oversampled units, both
    conventions reduce to: f_image_units = k_grid / n_orig ... in FOV cycles:
    f = k (cycles per FOV) since FFT bin k of the FOV is k cycles per FOV).

    Concretely: FFT bin (u, v) of the original n-grid corresponds to u,v
    cycles per FOV; the FOV is [-1,1]^2 (length 2), so continuous frequency
    is (u/2, v/2) cycles per unit length.  The returned values are scaled by
    (n/2)^2 so they match a unit-amplitude DFT of the rasterized image.
    """
    fx = np.asarray(kx, np.float64) / 2.0
    fy = np.asarray(ky, np.float64) / 2.0
    out = np.zeros(np.broadcast(fx, fy).shape, dtype=np.complex128)
    for amp, a, b, x0, y0, phi in SHEPP_LOGAN_ELLIPSES:
        t = np.deg2rad(phi)
        fxr = fx * np.cos(t) + fy * np.sin(t)
        fyr = -fx * np.sin(t) + fy * np.cos(t)
        gamma = np.sqrt((a * fxr) ** 2 + (b * fyr) ** 2)
        phase = np.exp(-2j * np.pi * (fx * x0 + fy * y0))
        out += amp * a * b * _jinc(gamma) * phase
    # DFT of the n-grid rasterization ~ continuous FT / pixel area; pixel
    # area = (2/n)^2 over the [-1,1]^2 FOV.
    return out * (n / 2.0) ** 2


def birdcage_sensitivities(n: int, ncoils: int, dtype=np.complex64) -> np.ndarray:
    """Smooth synthetic coil sensitivity maps (ncoils, n, n), loosely modeled
    on a birdcage array — used to synthesize multicoil fixtures standing in
    for the git-lfs datasets the reference references but does not ship."""
    c = (np.arange(n) - n // 2) / (n / 2)
    x = c[None, :]
    y = c[:, None]
    maps = np.empty((ncoils, n, n), dtype=np.complex128)
    for j in range(ncoils):
        ang = 2.0 * np.pi * j / ncoils
        cx, cy = 1.3 * np.cos(ang), 1.3 * np.sin(ang)
        r2 = (x - cx) ** 2 + (y - cy) ** 2
        mag = 1.0 / (1.0 + r2)
        phs = np.exp(1j * (0.5 * (x * np.sin(ang) - y * np.cos(ang)) + ang))
        maps[j] = mag * phs
    # normalize so sum-of-squares ~ 1 at center
    sos = np.sqrt((np.abs(maps) ** 2).sum(axis=0)).max()
    return (maps / sos).astype(dtype)
