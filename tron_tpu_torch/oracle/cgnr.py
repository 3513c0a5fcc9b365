"""Plain reference of the port's iterative recon (`tron -i N`, CGNR per
sliding-window frame), in float32 PyTorch, written from the method and not
from the solver: it imports no kernel, operator or solver of the port.

Each frame solves the Ram-Lak-weighted normal equations of Knopp, Kunis and
Potts (Int. J. Biomed. Imaging 2007) by conjugate gradients,

    A^H W A x = A^H W d,      x_0 = 0,

with, for a frame of ``npe`` spokes of ``nro`` readouts at gridos 2 (nxos
= nro, images n = nro / 2):

- ``W``: the Ram-Lak weights a |ro - nro/2| + b, a = (2 - 2/npe)/nro,
  b = 1/npe (`src/tron.cu:405-416`), readout 0 weighted out;
- ``A^H``: TRON's gridding adjoint without density compensation: readout
  ro scattered at the integer radius ro - nro/2 along its spoke's golden
  angle with the separable KB weights of the grid points within the
  kernel's half-width, taps off the grid dropped (`src/tron.cu:465-536`),
  then the centred unnormalised inverse FFT, the centre crop and the
  deapodisation (`:623-637`); the gridder's 1/(nxos npe) is not applied;
- ``A``: the exact transpose of that adjoint: the deapodisation, the
  zero-pad, the centred unnormalised forward FFT and a gather with the
  same KB taps, clipped at the grid edge; readout 0 is no radius of the
  gridder and reads 0.

The loop runs ``niter`` iterations and stops earlier where the residual's
squared norm falls to ``rtol**2 <b, b>``, b = A^H W d.  The inner products
run over all the coils of a frame at once: one CG over the stacked coil
images, whose iterates the root sum of squares then combines.

Departures from Knopp 2007, all the port's too:

- CG on the normal equations (CGNE's normal form, no separate data-space
  residual): in exact arithmetic its iterates are Knopp's CGNR iterates;
- the weights are Ram-Lak's with readout 0 weighted out, not Voronoi
  areas, and there is no regularisation;
- A is a gridding forward (KB interpolation on a twice oversampled grid
  with deapodisation), not the exact NUDFT;
- the stop rule is a relative residual (``rtol``) besides the count.

``quant`` rounds the operands of every gridding and degridding as a kernel
at a lower precision would ("float32" leaves them; "bfloat16" rounds to
nearest even): gridding, each sample times its y-weight and the x-weight;
degridding, the grid values and the x-weights.  KB weights, positions and
deapodisation are computed in float64 and applied in float32; TF32 stays
off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the port's stop rule (`solver.cgnr_radial2d`)
RTOL = 1e-6
# golden-angle increment pi / golden ratio (`src/tron.cu:90`)
PHI = math.pi / ((1.0 + math.sqrt(5.0)) / 2.0)
# Blair & Edwards' rational approximation to I0(x), |x| <= 15 (`src/tron.cu:304-321`)
_I0_NUM = (
    0.210580722890567e-22, 0.380715242345326e-19, 0.479440257548300e-16,
    0.435125971262668e-13, 0.300931127112960e-10, 0.160224679395361e-7,
    0.654858370096785e-5, 0.202591084143397e-2, 0.463076284721000e0,
    0.754337328948189e2, 0.830792541809429e4, 0.571661130563785e6,
    0.216415572361227e8, 0.356644482244025e9, 0.144048298227235e10,
)
_I0_DEN = (1.0, -0.307646912682801e4, 0.347626332405882e7, -0.144048298227235e10)


def rounding(quant: str):
    """x -> x rounded to ``quant`` ("float32" or "bfloat16") and back to
    float32, a complex tensor part by part."""
    if quant == "float32":
        return lambda x: x
    if quant != "bfloat16":
        raise ValueError(f"unknown quant {quant!r}")

    def q(x):
        if x.is_complex():
            return torch.complex(q(x.real), q(x.imag))
        return x.to(torch.bfloat16).to(torch.float32)
    return q


def golden_angles(npe: int, skip: int) -> torch.Tensor:
    """float32 angles of spokes skip .. skip+npe-1, PHI * index wrapped to
    [0, 2 pi) (`src/tron.cu:372-378, 509`)."""
    x = torch.tensor(PHI, dtype=torch.float32) * (
        torch.arange(npe, dtype=torch.float32) + torch.tensor(float(skip)))
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32)
    y = torch.fmod(x, two_pi)
    return torch.where(y < 0, y + two_pi, y)


def weights(nro: int, npe: int) -> torch.Tensor:
    """W: the Ram-Lak weights of one spoke (nro,) float32, readout 0 zero."""
    r = torch.arange(nro, dtype=torch.float64)
    w = ((2.0 - 2.0 / npe) / nro * (r - nro // 2).abs() + 1.0 / npe).to(torch.float32)
    w[0] = 0
    return w


def _kb(d: torch.Tensor, kw: float) -> torch.Tensor:
    """0.5 I0(beta sqrt(1 - (d/kw)^2)) / kw for |d| < kw, beta = 2.34 * 2 kw."""
    z = (2.34 * 2.0 * kw) ** 2 * torch.clamp(1.0 - (d / kw) ** 2, min=0.0)
    num = torch.full_like(z, _I0_NUM[0])
    for c in _I0_NUM[1:]:
        num = num * z + c
    den = torch.full_like(z, _I0_DEN[0])
    for c in _I0_DEN[1:]:
        den = den * z + c
    return torch.where(d.abs() < kw, (0.5 / kw) * (-num / den), torch.zeros_like(d))


def _deapod(n: int, nxos: int, kw: float, device) -> torch.Tensor:
    """The KB window's transform over n pixels of an nxos-point grid,
    centred at n//2, both axes multiplied (`src/tron.cu:351-370, 390-402`)."""
    u = (torch.arange(n, dtype=torch.float64) - n // 2) / nxos
    beta = 2.34 * 2.0 * kw
    q = (math.pi * 2.0 * kw * u) ** 2 - beta * beta
    az = torch.sqrt(q.abs())
    safe = torch.where(az > 1e-12, az, torch.ones_like(az))
    w = torch.where(q > 0, torch.sin(safe) / safe, torch.sinh(safe) / safe)
    w = torch.where(az > 1e-12, w, torch.ones_like(w))
    return (w[:, None] * w[None, :]).to(device, torch.float32)


def _taps(pos: torch.Tensor, kw: float, nxos: int):
    """Per tap of each position (float64, grid points from the centre):
    its flat index on the axis (clamped) and its KB weight, 0 off the grid."""
    h = nxos // 2
    first = torch.floor(pos - kw) + 1
    out = []
    for t in range(math.ceil(2 * kw)):
        p = first + t
        w = torch.where((p >= -h) & (p < h), _kb(pos - p, kw), torch.zeros_like(pos))
        out.append((torch.clamp(p + h, 0, nxos - 1).long(), w.to(torch.float32)))
    return out


class Frames:
    """A and A^H of F frames at once: ``angles`` (F, npe) float32, ``nro``
    readouts at gridos 2, KB half-width ``kw``."""

    def __init__(self, angles: torch.Tensor, nro: int, kw: float, quant: str = "float32"):
        self.nro, self.nxos, self.n, self.kw = nro, nro, nro // 2, kw
        self.q = rounding(quant)
        dev = angles.device
        r = (torch.arange(1, nro, dtype=torch.float64, device=dev) - nro // 2)[None, None, :]
        a = angles.to(torch.float64)[:, :, None]
        self.xt = _taps(r * torch.cos(a), kw, self.nxos)      # (F, npe, nro - 1) each
        self.yt = _taps(r * torch.sin(a), kw, self.nxos)
        self.deapod = _deapod(self.n, self.nxos, kw, dev)

    def adjoint(self, y: torch.Tensor) -> torch.Tensor:
        """A^H: samples (F, C, npe, nro) complex64 -> coil images (F, C, n, n)."""
        F, C, npe, _ = y.shape
        N = self.nxos
        s = torch.view_as_real(y[..., 1:].permute(0, 2, 3, 1)).reshape(F, npe, -1, 2 * C)
        base = (torch.arange(F, device=y.device) * N * N)[:, None, None]
        acc = torch.zeros((F * N * N, 2 * C), dtype=torch.float32, device=y.device)
        for iy, wy in self.yt:
            u = self.q(s * wy[..., None])
            for ix, wx in self.xt:
                acc.index_add_(0, (base + iy * N + ix).reshape(-1),
                               (u * self.q(wx)[..., None]).reshape(-1, 2 * C))
        k = torch.view_as_complex(acc.reshape(F, N, N, C, 2).permute(0, 3, 1, 2, 4).contiguous())
        ax = (-2, -1)
        img = torch.fft.fftshift(torch.fft.ifft2(torch.fft.ifftshift(k, dim=ax), dim=ax,
                                                 norm="forward"), dim=ax)
        w = (N - self.n) // 2
        img = img[..., w:w + self.n, w:w + self.n]
        return torch.where(self.deapod > 0, img / self.deapod, img)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """A: coil images (F, C, n, n) complex64 -> samples (F, C, npe, nro)."""
        F, C = x.shape[:2]
        N, w = self.nxos, (self.nxos - self.n) // 2
        ax = (-2, -1)
        pad = x.new_zeros((F, C, N, N))
        pad[..., w:w + self.n, w:w + self.n] = torch.where(self.deapod > 0, x / self.deapod, x)
        k = torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(pad, dim=ax), dim=ax), dim=ax)
        g = torch.view_as_real(self.q(k)).permute(0, 2, 3, 1, 4).reshape(F, N * N, 2 * C)
        npe, R = self.xt[0][0].shape[1:]
        acc = torch.zeros((F, npe * R, 2 * C), dtype=torch.float32, device=x.device)
        for iy, wy in self.yt:
            row = torch.zeros_like(acc)
            for ix, wx in self.xt:
                idx = (iy * N + ix).reshape(F, -1, 1).expand(-1, -1, 2 * C)
                row += torch.gather(g, 1, idx) * self.q(wx).reshape(F, -1, 1)
            acc += row * wy.reshape(F, -1, 1)
        out = torch.view_as_complex(acc.reshape(F, npe, R, C, 2).permute(0, 3, 1, 2, 4)
                                    .contiguous())
        return torch.cat([out.new_zeros((F, C, npe, 1)), out], dim=-1)


def _inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> per frame over the coils and pixels, real float32 (F,)."""
    return torch.sum(torch.conj(a) * b, dim=(1, 2, 3)).real


def cgnr(d: torch.Tensor, angles: torch.Tensor, kw: float, niter: int, rtol: float = RTOL,
         quant: str = "float32") -> tuple[torch.Tensor, torch.Tensor]:
    """Frames' samples (F, C, npe, nro) complex64 on their spokes' angles
    (F, npe) -> (coil images (F, C, n, n), iterations each frame ran (F,))."""
    ops = Frames(angles, d.shape[-1], kw, quant)
    W = weights(d.shape[-1], d.shape[-2]).to(d.device)
    return cg(ops.adjoint(W * d), lambda p: ops.adjoint(W * ops.forward(p)), niter, rtol)


def cg(b: torch.Tensor, normal, niter: int, rtol: float = RTOL
       ) -> tuple[torch.Tensor, torch.Tensor]:
    """CG from 0 on normal(x) = b, each frame of b (F, C, n, n) on its own:
    at most ``niter`` iterations, a frame frozen once its residual's squared
    norm falls to rtol^2 <b, b> -> (x, iterations each frame ran (F,))."""
    thresh = rtol * rtol * _inner(b, b)
    x, r, p = torch.zeros_like(b), b, b
    rs = _inner(r, r)
    live = torch.ones_like(rs, dtype=torch.bool)
    its = torch.zeros_like(rs, dtype=torch.int64)
    for _ in range(niter):
        live = live & (rs > thresh)
        if not bool(live.any()):
            break
        Ap = normal(p)
        alpha = torch.where(live, rs / torch.clamp(_inner(p, Ap), min=1e-30), 0.0)
        x = x + alpha[:, None, None, None] * p
        r = r - alpha[:, None, None, None] * Ap
        rs_new = _inner(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = torch.where(live[:, None, None, None], r + beta[:, None, None, None] * p, p)
        rs = torch.where(live, rs_new, rs)
        its += live
    return x, its


def sos(coilimg: torch.Tensor) -> torch.Tensor:
    """(F, C, n, n) -> (F, n, n) complex64: the coils' root sum of squares."""
    return torch.sqrt((coilimg.abs() ** 2).sum(dim=1)).to(torch.complex64)


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
