"""Coil combination (counterpart of `tron_tpu/ops/coil.py`): root sum of
squares.  Walsh adaptive combine and coil compression are still to port
(ROADMAP A16)."""

from __future__ import annotations

import torch


def coil_combine_sos(coilimg: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Root-sum-of-squares over the channel axis; passthrough if singleton.

    Returns the input's (complex) dtype with zero imaginary part, matching
    the reference output convention (`src/tron.cu:263-264`).
    """
    if coilimg.shape[axis] == 1:
        return coilimg.select(axis, 0)
    mag = torch.sqrt(torch.sum(torch.abs(coilimg) ** 2, dim=axis))
    return mag.to(coilimg.dtype)
