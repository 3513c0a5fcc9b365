"""Image/data quality metrics — the rebuild of the reference's MATLAB
metric layer (`src/rmse.m`, `src/lmse.m`, `src/lmsediff.m`, the inline NMSE
of `src/RUNME2_others_degrid_phantom.m:96`, and the MATLAB `ssim` calls of
`src/RUNME4_others_grid_slcmt.m:283-312`).

All functions accept numpy arrays (or CPU tensors), real or complex.  A
copy of `tron_tpu/metrics.py`, which is numpy only: importing it would
import JAX through `tron_tpu/__init__.py`, and the card has no JAX.
"""

from __future__ import annotations

import numpy as np


def rmse(a, b) -> float:
    """Root-mean-square error (src/rmse.m)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2)))


def nrmse(a, b) -> float:
    """RMSE normalized by ||b||."""
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def nmse(a, b) -> float:
    """Normalized mean-square error, as printed by RUNME2:96."""
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2))


def lmse(a, b) -> float:
    """Least-squares-scaled MSE (scale-invariant, src/lmse.m): the error
    after the optimal complex scale of a onto b."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    s = np.vdot(a, b) / np.vdot(a, a)
    return float(np.linalg.norm(s * a - b) ** 2 / b.size)


def lmsediff(a, b):
    """The scaled difference image itself (src/lmsediff.m)."""
    a = np.asarray(a)
    b = np.asarray(b)
    s = np.vdot(a.ravel(), b.ravel()) / np.vdot(a.ravel(), a.ravel())
    return s * a - b


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2(img: np.ndarray, w: np.ndarray) -> np.ndarray:
    """'valid' 2D correlation with a small window (separable-free, direct)."""
    from numpy.lib.stride_tricks import sliding_window_view

    v = sliding_window_view(img, w.shape)
    return np.einsum("ijkl,kl->ij", v, w)


def ssim(a, b, data_range: float | None = None) -> float:
    """Structural similarity index, matching the standard Wang et al. 2004
    formulation MATLAB's `ssim` implements (gaussian window 11x11, sigma
    1.5, K1=0.01, K2=0.03).  Inputs are magnitude images.
    """
    a = np.abs(np.asarray(a)).astype(np.float64)
    b = np.abs(np.asarray(b)).astype(np.float64)
    if data_range is None:
        data_range = b.max() - b.min()
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    w = _gaussian_window()
    mu_a = _filter2(a, w)
    mu_b = _filter2(b, w)
    mu_a2, mu_b2, mu_ab = mu_a**2, mu_b**2, mu_a * mu_b
    sa = _filter2(a * a, w) - mu_a2
    sb = _filter2(b * b, w) - mu_b2
    sab = _filter2(a * b, w) - mu_ab
    m = ((2 * mu_ab + C1) * (2 * sab + C2)) / ((mu_a2 + mu_b2 + C1) * (sa + sb + C2))
    return float(m.mean())
