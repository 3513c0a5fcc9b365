"""The plain reference of TRON's iterative recon with the Toeplitz normal
operator (`tron -i N --toeplitz`): each sliding-window frame solved by
conjugate gradients on the Ram-Lak-weighted normal equations, the normal
operator applied as a convolution with the samples' point-spread function
(Wajer and Pruessmann, ISMRM 2001; Fessler et al., "Toeplitz-based
iterative image reconstruction for MRI with correction for magnetic field
inhomogeneity", IEEE Trans. Signal Process. 53(9), 2005), in PyTorch,
written from the method and not from the program under test: it imports
nothing of it.  It builds on the CGNR reference (`cgnr.py`), whose frames,
weights and right side it keeps.

For a frame of ``work`` golden-angle spokes of ``nro`` readouts at gridos 2
(images n = nro / 2), from x = 0, for ``niter`` iterations, stopping earlier
where the residual's squared norm falls to rtol^2 <b, b> (rtol 1e-6), then
the coils' root sum of squares:

    T x = b,    b = A^H W d,    (T x)[p] = sum_q t[p - q] x[q],
    t[d] = sum_m w_m exp(+2i pi k_m . d / nro),  d in [-n, n)^2,

with ``W`` and ``A^H`` those of `cgnr.py` (Ram-Lak weights with readout 0
out; the gridding adjoint on integer radii without density compensation
and without its 1/(nxos work) scale).  t is built as the program documents
it: the weights gridded at the doubled geometry, readout ro (1 .. nro - 1)
at radius 2 (ro - nro/2) of a 2 nxos-point grid, one complex channel,
readout 0 out, no density compensation and no scale, then the inverse FFT,
the crop to 2n and the deapodisation at that grid (`nufft.image_of_grid`);
the multiplier is fft2(ifftshift(t)).  T is applied as a circular
convolution on 2n x 2n, where no offset wraps: the image zero-padded into
the grid's corner, ``fft2``, the product, ``ifft2``, the crop.

Departures from Fessler 2005, the program's too: t is KB-gridded, not the
exact DTFT sum; the right side is the gridding adjoint, so T is not that
adjoint composed with its transpose; Ram-Lak weights with readout 0 out,
no regularisation and no field term; the relative-residual stop besides
the count; one CG over all the coils of a frame.

Everything is computed in float32 with the KB and deapodisation weights and
the sample positions in float64, TF32 off.  ``quant`` rounds the operands
of every gridding, the right side's and the multiplier's, as a kernel at a
lower precision would (`nufft.rounding`): the samples times the y-weights
and the x-weights.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import cgnr, nufft

# the recon settings the reference works out, each with the values it takes
# (None: any); gridos 2 only, where the program grids the multiplier
SETTINGS = {**cgnr.SETTINGS, "gridos": (2.0,), "toeplitz": (True,)}


class Series(cgnr.Series):
    """One series' input on ``device`` and its frames' geometry."""

    def __init__(self, indata: np.ndarray, recon: dict, device):
        for k, v in recon.items():
            if k not in SETTINGS or (SETTINGS[k] is not None and v not in SETTINGS[k]):
                raise ValueError(f"the reference does not work out the recon setting {k}={v!r}")
        super().__init__(indata, {k: v for k, v in recon.items() if k != "toeplitz"}, device)
        self.recon = recon
        # readouts 1 .. nro - 1 at their doubled radii; readout 0 is out
        self.radii2 = 2.0 * (torch.arange(1, self.nro, dtype=torch.float64) - self.nro // 2)

    def multiplier(self, a: torch.Tensor, quant: str) -> torch.Tensor:
        """fft2(ifftshift(t)) of each frame's spokes (F, work): (F, 2n, 2n)."""
        F = a.shape[0]
        s = self.w[1:].to(torch.complex64).expand(F, 1, self.work, self.nro - 1)
        kg = nufft.grid(s, self.radii2, a, 2 * self.nxos, self.kw, quant)
        t = nufft.image_of_grid(kg, 2 * self.n, self.kw)[:, 0]
        return torch.fft.fft2(torch.fft.ifftshift(t, dim=(-2, -1)))

    @staticmethod
    def apply(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
        """T on coil images (F, C, n, n), each frame's multiplier (F, 2n, 2n)."""
        n = x.shape[-1]
        xp = x.new_zeros(x.shape[:-2] + (2 * n, 2 * n))
        xp[..., :n, :n] = x
        return torch.fft.ifft2(torch.fft.fft2(xp) * mult[:, None])[..., :n, :n]

    def solve(self, d: torch.Tensor, a: torch.Tensor, quant: str) -> torch.Tensor:
        """CG from 0 on each frame's T x = A^H W d -> coil images."""
        b = self.adjoint(self.w * d, a, quant)
        mult = self.multiplier(a, quant)
        thresh = cgnr.RTOL * cgnr.RTOL * cgnr._inner(b, b)
        x, r, p = torch.zeros_like(b), b, b
        rs = cgnr._inner(r, r)
        live = torch.ones_like(rs, dtype=torch.bool)
        for _ in range(self.niter):
            live = live & (rs > thresh)
            if not bool(live.any()):
                break
            Ap = self.apply(p, mult)
            alpha = torch.where(live, rs / torch.clamp(cgnr._inner(p, Ap), min=1e-30), 0.0)
            x = x + alpha[:, None, None, None] * p
            r = r - alpha[:, None, None, None] * Ap
            rs_new = cgnr._inner(r, r)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            p = torch.where(live[:, None, None, None], r + beta[:, None, None, None] * p, p)
            rs = torch.where(live, rs_new, rs)
        return x
