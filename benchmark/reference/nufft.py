"""The plain reference of TRON's radial recon, in PyTorch, written from the
method (Kaiser-Bessel gridding of golden-angle spokes, TRON, MRM 2018,
doi:10.1002/mrm.27497, and the reference program `src/tron.cu`) and not from
the program under test: it imports nothing of it.

Each frame of a sliding-window series is gridded sample by sample: every
sample scatters into the grid points within the kernel's half-width, with
the separable KB weight of each (`src/tron.cu:465-536`), then the centred
unnormalised inverse FFT, the crop and the deapodisation
(`src/tron.cu:623-637`), and the coils' root sum of squares.

Everything is computed in float32 with the KB and deapodisation weights and
the sample positions in float64.  ``quant`` rounds the operands of the
gridding contraction, as a kernel at a lower precision would: the samples
times the y-weights and the x-weights of each term (``rounding``).
"""

from __future__ import annotations

import math

import torch

# Golden-angle increment pi / golden ratio, in float32 as the reference
# program computes its angles (`src/tron.cu:90, 509`)
PHI = math.pi / ((1.0 + math.sqrt(5.0)) / 2.0)

# Blair & Edwards' rational approximation to I0(x) for |x| <= 15, the
# reference program's (`src/tron.cu:304-321`)
_I0_NUM = (
    0.210580722890567e-22, 0.380715242345326e-19, 0.479440257548300e-16,
    0.435125971262668e-13, 0.300931127112960e-10, 0.160224679395361e-7,
    0.654858370096785e-5, 0.202591084143397e-2, 0.463076284721000e0,
    0.754337328948189e2, 0.830792541809429e4, 0.571661130563785e6,
    0.216415572361227e8, 0.356644482244025e9, 0.144048298227235e10,
)
_I0_DEN = (1.0, -0.307646912682801e4, 0.347626332405882e7, -0.144048298227235e10)

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def rounding(quant: str):
    """x -> x rounded to ``quant`` and back to float32: "float32" leaves x
    as it is, "bfloat16" rounds to nearest even, "float8_e4m3" scales the
    whole tensor so that its largest magnitude is the format's largest,
    rounds, and scales back (a per-tensor scale, as an fp8 kernel would
    take).  A complex tensor is rounded part by part."""
    if quant == "float32":
        return lambda x: x
    if quant == "bfloat16":
        def q(x):
            if x.is_complex():
                return torch.complex(q(x.real), q(x.imag))
            return x.to(torch.bfloat16).to(torch.float32)
        return q
    if quant == "float8_e4m3":
        def q(x):
            if x.is_complex():
                amax = torch.maximum(x.real.abs().amax(), x.imag.abs().amax())
                s = FP8_MAX / torch.clamp(amax, min=1e-30)
                return torch.complex(_fp8(x.real, s), _fp8(x.imag, s))
            return _fp8(x, FP8_MAX / torch.clamp(x.abs().amax(), min=1e-30))
        return q
    raise ValueError(f"unknown quant {quant!r}")


def _fp8(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def kb_beta(kernwidth: float) -> float:
    """The KB shape parameter, 2.34 times the full width (`src/tron.cu:323-335`)."""
    return 2.34 * 2.0 * kernwidth


def _i0(x: torch.Tensor) -> torch.Tensor:
    z = x * x
    num = torch.full_like(z, _I0_NUM[0])
    for c in _I0_NUM[1:]:
        num = num * z + c
    den = torch.full_like(z, _I0_DEN[0])
    for c in _I0_DEN[1:]:
        den = den * z + c
    return -num / den


def kb(d: torch.Tensor, kernwidth: float, beta: float) -> torch.Tensor:
    """The KB window 0.5 I0(beta sqrt(1 - (d/kw)^2)) / kw for |d| < kw,
    else 0 (`src/tron.cu:338-349`)."""
    r = d / kernwidth
    f = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    return torch.where(r.abs() < 1.0, (0.5 / kernwidth) * _i0(beta * f), torch.zeros_like(d))


def kb_hat(u: torch.Tensor, kernwidth: float, beta: float) -> torch.Tensor:
    """The KB window's Fourier transform at u cycles per oversampled field of
    view (`src/tron.cu:351-370`)."""
    r = math.pi * 2.0 * kernwidth * u
    q = r * r - beta * beta
    az = torch.sqrt(q.abs())
    safe = torch.where(az > 1e-12, az, torch.ones_like(az))
    y = torch.where(q > 0, torch.sin(safe) / safe, torch.sinh(safe) / safe)
    return torch.where(az > 1e-12, y, torch.ones_like(y))


def golden_angles(npe: int, skip: int) -> torch.Tensor:
    """float32 angles of spokes skip .. skip+npe-1: PHI * index wrapped to
    [0, 2 pi) by an exact fmod (`src/tron.cu:372-378, 509`), on the CPU."""
    x = torch.tensor(PHI, dtype=torch.float32) * (
        torch.arange(npe, dtype=torch.float32) + torch.tensor(float(skip), dtype=torch.float32))
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32)
    y = torch.fmod(x, two_pi)
    return torch.where(y < 0, y + two_pi, y)


def ramlak(nro: int, npe: int) -> torch.Tensor:
    """Ram-Lak weights along the readout, a |ro - nro/2| + b with
    a = (2 - 2/npe)/nro, b = 1/npe (`src/tron.cu:405-416`), float32."""
    r = torch.arange(nro, dtype=torch.float64)
    return ((2.0 - 2.0 / npe) / nro * (r - nro // 2).abs() + 1.0 / npe).to(torch.float32)


def _taps(pos: torch.Tensor, kernwidth: float, beta: float, lo: int, n: int):
    """The grid points within the kernel of each position ``pos`` (float64,
    in points of an axis whose first point is ``lo``): per tap, the point's
    index into the axis (clamped) and its KB weight, zero off the axis."""
    first = torch.floor(pos - kernwidth) + 1
    taps = []
    for t in range(math.ceil(2 * kernwidth)):
        p = first + t
        inside = (p >= lo) & (p < lo + n)
        w = torch.where(inside, kb(pos - p, kernwidth, beta), torch.zeros_like(pos))
        taps.append((torch.clamp(p - lo, 0, n - 1).long(), w.to(torch.float32)))
    return taps


def grid(samples: torch.Tensor, radii: torch.Tensor, angles: torch.Tensor, nxos: int,
         kernwidth: float, quant: str = "float32") -> torch.Tensor:
    """Samples (F, C, npe, R) complex64 at signed radii (R,) along each
    frame's angles (F, npe) -> (F, C, nxos, nxos) complex64 k-space grids
    [y, x], centred at nxos//2, unscaled; every tap off the grid is dropped."""
    F, C, npe, R = samples.shape
    dev = samples.device
    beta = kb_beta(kernwidth)
    q = rounding(quant)
    h = nxos // 2
    r = radii.to(dev, torch.float64)[None, None, :]
    a = angles.to(dev, torch.float64)[:, :, None]
    xt = _taps(r * torch.cos(a), kernwidth, beta, -h, nxos)     # (F, npe, R) each
    yt = _taps(r * torch.sin(a), kernwidth, beta, -h, nxos)
    s = torch.view_as_real(samples.permute(0, 2, 3, 1)).reshape(F, npe, R, 2 * C)
    base = (torch.arange(F, device=dev) * nxos * nxos)[:, None, None]
    acc = torch.zeros((F * nxos * nxos, 2 * C), dtype=torch.float32, device=dev)
    for iy, wy in yt:
        u = q(s * wy[..., None])
        for ix, wx in xt:
            idx = (base + iy * nxos + ix).reshape(-1)
            acc.index_add_(0, idx, (u * q(wx)[..., None]).reshape(-1, 2 * C))
    g = acc.reshape(F, nxos, nxos, C, 2).permute(0, 3, 1, 2, 4).contiguous()
    return torch.view_as_complex(g)


def centered_ifft2(k: torch.Tensor) -> torch.Tensor:
    """Centred k-space -> centred image, the inverse DFT without 1/N."""
    ax = (-2, -1)
    return torch.fft.fftshift(
        torch.fft.ifft2(torch.fft.ifftshift(k, dim=ax), dim=ax, norm="forward"), dim=ax)


def deapod_weights(n: int, nxos: int, kernwidth: float, device) -> torch.Tensor:
    """The KB rolloff over n points of an nxos-point transform, centred at
    n//2, per axis and multiplied (`src/tron.cu:390-402`)."""
    p = torch.arange(n, dtype=torch.float64) - n // 2
    w = kb_hat(p / nxos, kernwidth, kb_beta(kernwidth))
    return (w[:, None] * w[None, :]).to(device, torch.float32)


def deapodize(img: torch.Tensor, nxos: int, kernwidth: float) -> torch.Tensor:
    """img / rolloff where the rolloff is positive; elsewhere img."""
    w = deapod_weights(img.shape[-1], nxos, kernwidth, img.device)
    return torch.where(w > 0, img / w, img)


def image_of_grid(kgrid: torch.Tensor, n: int, kernwidth: float) -> torch.Tensor:
    """Grids (..., nxos, nxos) -> deapodised images (..., n, n): the inverse
    FFT, the centre crop."""
    nxos = kgrid.shape[-1]
    img = centered_ifft2(kgrid)
    w = (nxos - n) // 2
    return deapodize(img[..., w:w + n, w:w + n], nxos, kernwidth)


def sos(coilimg: torch.Tensor) -> torch.Tensor:
    """(F, C, n, n) -> (F, n, n) complex64: the coils' root sum of squares
    (a single coil passes through)."""
    if coilimg.shape[1] == 1:
        return coilimg[:, 0]
    return torch.sqrt((coilimg.abs() ** 2).sum(dim=1)).to(torch.complex64)
