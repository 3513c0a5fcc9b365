"""Centered FFTs, crop/pad, deapodization (counterpart of the FFT half of
`tron_tpu/ops/fftops.py`; `torch.fft` is cuFFT on the card).

Images and k-space grids are (..., ny, nx), centered at index n//2 on both
axes.  The inverse transform is *unnormalized* (cuFFT INVERSE semantics,
`src/tron.cu:632`).  The JAX package's MXU DFT sandwich is a TPU
workaround for a slow FFT and has no counterpart here.
"""

from __future__ import annotations

import torch

from tron_tpu_torch.kernels.kb import kb_hat

_AXES = (-2, -1)


def centered_fft2(img: torch.Tensor) -> torch.Tensor:
    """Centered image -> centered k-space, unnormalized forward DFT."""
    return torch.fft.fftshift(
        torch.fft.fft2(torch.fft.ifftshift(img, dim=_AXES), dim=_AXES), dim=_AXES
    )


def centered_ifft2_unnormalized(kgrid: torch.Tensor) -> torch.Tensor:
    """Centered k-space -> centered image, inverse DFT with no 1/N factor."""
    out = torch.fft.ifft2(torch.fft.ifftshift(kgrid, dim=_AXES), dim=_AXES, norm="forward")
    return torch.fft.fftshift(out, dim=_AXES)


def crop_center(img: torch.Tensor, n: int) -> torch.Tensor:
    """Center-crop the trailing two axes to (n, n) (`src/tron.cu:418-431`)."""
    w = (img.shape[-1] - n) // 2
    return img[..., w : w + n, w : w + n]


def pad_center(img: torch.Tensor, nos: int) -> torch.Tensor:
    """Center zero-pad the trailing two axes to (nos, nos) (without the
    reference's off-by-one at `src/tron.cu:435-457`)."""
    n = img.shape[-1]
    w = (nos - n) // 2
    out = img.new_zeros(img.shape[:-2] + (nos, nos))
    out[..., w : w + n, w : w + n] = img
    return out


def deapod_weights(
    n: int, nxos: int, kernwidth: float, beta: float, device=None
) -> torch.Tensor:
    """Separable deapodization weights for an (n, n) block of an nxos-unit
    transform: w[p] = kb_hat((p - n//2)/nxos) per axis (`src/tron.cu:390-402`)."""
    p = (torch.arange(n, device=device) - n // 2).to(torch.float32)
    w = kb_hat(p * (1.0 / nxos), kernwidth, beta)
    return w[:, None] * w[None, :]


def deapodize(img: torch.Tensor, nxos: int, kernwidth: float, beta: float) -> torch.Tensor:
    """Divide out the KB kernel's image-domain rolloff; where the weight is
    <= 0 the pixel passes through (`src/tron.cu:400`)."""
    w = deapod_weights(img.shape[-1], nxos, kernwidth, beta, device=img.device)
    return torch.where(w > 0, img / w.to(img.dtype), img)
