"""Plain reference of the port's CGNR with the Toeplitz normal operator
(`tron -i N --toeplitz`), in float32 PyTorch, written from the method and
not from the solver: it imports no kernel, operator or solver of the port,
only the plain CGNR reference beside it (`oracle/cgnr.py`), whose right
side A^H W d, weights, CG loop and root sum of squares it keeps.

The normal operator A^H W A of a frame is a convolution of the image with
the point-spread function of its samples (Wajer and Pruessmann, ISMRM
2001; Fessler et al., IEEE Trans. Signal Process. 53(9), 2005),

    (A^H W A x)[p] = sum_q t[p - q] x[q],   t[d] = sum_m w_m exp(+2i pi k_m . d / nro),

over offsets d in [-n, n)^2 (images n = nro / 2, samples k_m at the
integer radii ro - nro/2 along their spokes' golden angles, weights w_m
the Ram-Lak row with readout 0 out).  It is applied as a circular
convolution on a 2n x 2n grid, where no offset wraps: the image zero-padded
into the grid's corner, ``fft2``, the product with the multiplier
fft2(ifftshift(t)), ``ifft2`` and the crop of that corner.

The multiplier is built the way the program documents it: t is the
gridding adjoint of the weights at the doubled geometry, 2 nro readouts a
spoke on a 2 nro-point grid (images 2n), the weights in the even slots (so
readout ro sits at the doubled radius 2 (ro - nro/2), where on that grid
the phase exp(+2i pi 2k . d / 2nro) is the one above), readout 0 and the
odd slots out; the KB scatter, the centred unnormalised inverse FFT, the
crop to 2n and the deapodisation of `oracle/cgnr.py`, with no density
compensation and no 1/(nxos' npe) scale.

Departures from Fessler 2005, all the port's too:

- t is KB-gridded (the doubled-geometry adjoint, deapodised), not the
  exact DTFT sum; the two differ by the gridding's own error;
- the right side A^H W d is the gridding adjoint of `oracle/cgnr.py`, so
  the operator solved is the PSF's convolution, not that adjoint composed
  with its transpose;
- the weights are Ram-Lak's with readout 0 out, with no regularisation and
  no field-inhomogeneity term (Fessler's time segmentation);
- CG runs on the normal equations with the relative-residual stop rtol
  besides the count, over all the coils of a frame at once.

Everything is computed in float32 with the KB and deapodisation weights and
the positions in float64, TF32 off.  ``quant`` rounds the operands of every
gridding, the right side's and the multiplier's, as a kernel at a lower
precision would (`oracle/cgnr.rounding`).
"""

from __future__ import annotations

import numpy as np
import torch

from tron_tpu_torch.oracle.cgnr import RTOL, Frames, cg, golden_angles, sos, weights


def multiplier(angles: torch.Tensor, nro: int, kw: float, quant: str = "float32"
               ) -> torch.Tensor:
    """fft2(ifftshift(t)) of each frame, (F, 2n, 2n) complex64, from the
    spokes' angles (F, npe) of ``nro`` readouts."""
    F, npe = angles.shape
    w2 = torch.zeros((F, 1, npe, 2 * nro), dtype=torch.complex64, device=angles.device)
    w2[..., ::2] = weights(nro, npe).to(angles.device)
    t = Frames(angles, 2 * nro, kw, quant).adjoint(w2)[:, 0]
    return torch.fft.fft2(torch.fft.ifftshift(t, dim=(-2, -1)))


def apply(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """The normal operator on coil images x (F, C, n, n) with each frame's
    multiplier (F, 2n, 2n)."""
    n = x.shape[-1]
    xp = x.new_zeros(x.shape[:-2] + (2 * n, 2 * n))
    xp[..., :n, :n] = x
    return torch.fft.ifft2(torch.fft.fft2(xp) * mult[:, None])[..., :n, :n]


def cgnr(d: torch.Tensor, angles: torch.Tensor, kw: float, niter: int, rtol: float = RTOL,
         quant: str = "float32") -> tuple[torch.Tensor, torch.Tensor]:
    """Frames' samples (F, C, npe, nro) complex64 on their spokes' angles
    (F, npe) -> (coil images (F, C, n, n), iterations each frame ran (F,))."""
    nro = d.shape[-1]
    W = weights(nro, d.shape[-2]).to(d.device)
    b = Frames(angles, nro, kw, quant).adjoint(W * d)
    mult = multiplier(angles, nro, kw, quant)
    return cg(b, lambda p: apply(p, mult), niter, rtol)


def series(indata, frames: list[int], *, work: int, slide: int, kernwidth: float, niter: int,
           quant: str = "float32", device="cpu") -> torch.Tensor:
    """The combined images (F, n, n) complex64 of ``frames`` of a
    sliding-window series, host samples in `.ra` dims (nc, 1, nro, npe1):
    frame z holds spokes z slide .. z slide + work - 1 at their golden
    angles (no skipped spokes)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = torch.as_tensor(np.asarray(indata)[:, 0]).to(device).transpose(1, 2)  # (nc, npe1, nro)
    d = torch.stack([data[:, z * slide:z * slide + work] for z in frames])
    a = torch.stack([golden_angles(work, z * slide) for z in frames]).to(device)
    return sos(cgnr(d, a, kernwidth, niter, quant=quant)[0])
