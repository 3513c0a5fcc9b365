"""The plain reference of TRON's iterative recon (`tron -i N`): each
sliding-window frame solved by conjugate gradients on the Ram-Lak-weighted
normal equations, in PyTorch, written from the method (CGNR, Knopp, Kunis
and Potts, Int. J. Biomed. Imaging 2007; TRON's loop, `src/tron.cu:689-711`,
and its dispatch, `:753-755`) and not from the program under test: it
imports nothing of it.

For a frame of ``work`` golden-angle spokes of ``nro`` readouts at gridos 2
(nxos = nro, images n = nro / 2), from x = 0,

    A^H W A x = A^H W d

for ``niter`` iterations, stopping earlier where the residual's squared
norm falls to rtol^2 <b, b> (b = A^H W d, rtol 1e-6), then the coils' root
sum of squares, with:

- ``W``: the Ram-Lak weights (`nufft.ramlak`), readout 0 weighted out;
- ``A^H``: the adjoint reference's gridding on integer radii
  (`recon._radius_rows`: readout ro at radius ro - nro/2, readout 0 never
  gridded) without density compensation and without its 1/(nxos work)
  scale, then the inverse FFT, the crop and the deapodisation
  (`nufft.image_of_grid`);
- ``A``: that adjoint's exact transpose: the deapodisation, the zero-pad,
  the centred unnormalised forward FFT and a gather at the same radii with
  the same KB taps, clipped at the grid's edge (`nufft._taps`); readout 0
  reads 0.

The inner products run over all the coils of a frame: one CG over the
stacked coil images.  Departures from Knopp 2007, the program's too: CG on
the normal equations (in exact arithmetic Knopp's CGNR iterates); Ram-Lak
weights with readout 0 out, not Voronoi areas, no regularisation; a
gridding forward (KB on a twice oversampled grid, deapodised) in place of
the exact NUDFT; the relative-residual stop besides the count.

Everything is computed in float32 with the KB and deapodisation weights and
the sample positions in float64, TF32 off.  ``quant`` rounds the operands
of every gridding and every degridding, as a kernel at a lower precision
would (`nufft.rounding`): gridding, the samples times the y-weights and the
x-weights; degridding, the grid values and the x-weights.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nufft
from benchmark.reference.forward import centered_fft2
from benchmark.reference.recon import _radius_rows, frame_geometry

RTOL = 1e-6

# the recon settings the reference works out, each with the values it takes
# (None: any); gridos 2 only, where the program's pair grids integer radii
SETTINGS = {"adjoint": (True,), "golden_angle": (True,), "data_undersamp": None,
            "prof_slide": None, "gridos": (2.0,), "kernwidth": None, "skip_angles": None,
            "niter": range(1, 1001), "toeplitz": (False,)}


def _inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> of each frame over its coils and pixels, real (F,)."""
    return torch.sum(torch.conj(a) * b, dim=(1, 2, 3)).real


class Series:
    """One series' input on ``device`` and its frames' geometry."""

    def __init__(self, indata: np.ndarray, recon: dict, device):
        for k, v in recon.items():
            if k not in SETTINGS or (SETTINGS[k] is not None and v not in SETTINGS[k]):
                raise ValueError(f"the reference does not work out the recon setting {k}={v!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        nc, _, nro, npe1 = indata.shape
        self.recon, self.device = recon, torch.device(device)
        self.nro, self.n, self.nxos = nro, nro // 2, nro
        self.kw = float(recon["kernwidth"])
        self.niter = int(recon["niter"])
        self.work, self.slide, self.nz = frame_geometry(recon, nro, npe1)
        rr, ridx = _radius_rows(self.nxos, nro)
        self.radii, self.ridx = rr, ridx.to(self.device)
        w = nufft.ramlak(nro, self.work)
        w[0] = 0
        self.w = w.to(self.device)
        # (nc, npe1, nro): spokes on the second axis
        self.data = torch.from_numpy(indata[:, 0]).to(self.device).transpose(1, 2)

    def window(self, frames: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """The frames' samples (F, C, work, nro) and angles (F, work)."""
        d = torch.stack([self.data[:, z * self.slide:z * self.slide + self.work]
                         for z in frames])
        a = torch.stack([nufft.golden_angles(self.work, self.recon["skip_angles"]
                                             + z * self.slide) for z in frames])
        return d, a.to(self.device)

    def adjoint(self, y: torch.Tensor, a: torch.Tensor, quant: str) -> torch.Tensor:
        """A^H: samples (F, C, work, nro) -> coil images (F, C, n, n)."""
        kg = nufft.grid(y[..., self.ridx], self.radii, a, self.nxos, self.kw, quant)
        return nufft.image_of_grid(kg, self.n, self.kw)

    def forward(self, x: torch.Tensor, a: torch.Tensor, quant: str) -> torch.Tensor:
        """A: coil images (F, C, n, n) -> samples (F, C, work, nro)."""
        F, C = x.shape[:2]
        N, h, w = self.nxos, self.nxos // 2, (self.nxos - self.n) // 2
        q = nufft.rounding(quant)
        beta = nufft.kb_beta(self.kw)
        pad = x.new_zeros((F, C, N, N))
        pad[..., w:w + self.n, w:w + self.n] = nufft.deapodize(x, N, self.kw)
        g = torch.view_as_real(q(centered_fft2(pad))).permute(0, 2, 3, 1, 4).reshape(
            F, N * N, 2 * C)
        r = self.radii.to(x.device, torch.float64)[None, None, :]
        ang = a.to(torch.float64)[:, :, None]
        xt = nufft._taps(r * torch.cos(ang), self.kw, beta, -h, N)     # (F, work, R) each
        yt = nufft._taps(r * torch.sin(ang), self.kw, beta, -h, N)
        R = r.shape[-1]
        acc = torch.zeros((F, self.work * R, 2 * C), dtype=torch.float32, device=x.device)
        for iy, wy in yt:
            row = torch.zeros_like(acc)
            for ix, wx in xt:
                idx = (iy * N + ix).reshape(F, -1, 1).expand(-1, -1, 2 * C)
                row += torch.gather(g, 1, idx) * q(wx).reshape(F, -1, 1)
            acc += row * wy.reshape(F, -1, 1)
        s = torch.view_as_complex(acc.reshape(F, self.work, R, C, 2).permute(0, 3, 1, 2, 4)
                                  .contiguous())
        out = s.new_zeros((F, C, self.work, self.nro))
        out[..., self.ridx] = s
        return out

    def solve(self, d: torch.Tensor, a: torch.Tensor, quant: str) -> torch.Tensor:
        """CG from 0 on each frame's normal equations -> coil images."""
        b = self.adjoint(self.w * d, a, quant)
        thresh = RTOL * RTOL * _inner(b, b)
        x, r, p = torch.zeros_like(b), b, b
        rs = _inner(r, r)
        live = torch.ones_like(rs, dtype=torch.bool)
        for _ in range(self.niter):
            live = live & (rs > thresh)
            if not bool(live.any()):
                break
            Ap = self.adjoint(self.w * self.forward(p, a, quant), a, quant)
            alpha = torch.where(live, rs / torch.clamp(_inner(p, Ap), min=1e-30), 0.0)
            x = x + alpha[:, None, None, None] * p
            r = r - alpha[:, None, None, None] * Ap
            rs_new = _inner(r, r)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            p = torch.where(live[:, None, None, None], r + beta[:, None, None, None] * p, p)
            rs = torch.where(live, rs_new, rs)
        return x

    def frames(self, frames: list[int], quant: str = "float32", block: int = 32
               ) -> torch.Tensor:
        """The combined images (F, n, n) complex64 of ``frames``, ``block``
        frames at a time."""
        out = []
        for i in range(0, len(frames), block):
            d, a = self.window(frames[i:i + block])
            out.append(nufft.sos(self.solve(d, a, quant)))
        return torch.cat(out)
