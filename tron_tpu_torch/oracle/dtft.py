"""Exact (slow) discrete-time Fourier transform oracle (counterpart of
`tron_tpu/oracle/dtft.py`).

The fast NUFFT ops are held against these O(N*M) direct sums on small
problems, and `dtft2_adjoint_chunked` scales the same exact sum to full
frame geometry in chunks of samples; the solver's exact Toeplitz kernel
(`solver.toeplitz_fourier_kernel(method="exact")`) is one such sum.

Convention (shared with tron_tpu_torch.nufft): image pixels live at
centered integer coordinates p, q in [-n/2, n/2) of an ``nos``-point
oversampled transform; a k-space sample at grid-unit frequency (kx, ky) is

    S(kx, ky) = sum_{q,p} img[..., q + n/2, p + n/2]
                  * exp(-2j*pi*(kx*p + ky*q) / nos)

which is exactly what centered-FFT-then-perfect-interpolation computes.
Complex64 throughout, as in the JAX package (whose einsums run at HIGHEST
precision; torch's complex products are full fp32 with TF32 off).
"""

from __future__ import annotations

import math

import torch

from tron_tpu_torch.ops.degrid import _mod, lattice_radii
from tron_tpu_torch.ops.grid import drop_readout0


def _phase(n: int, nos: int, k: torch.Tensor) -> torch.Tensor:
    """exp(-2j pi k p / nos) for all centered pixel coords p; shape (M, n).

    fp32-exact at large |k*p|: k = round(k) + frac, and the integer part of
    k*p (exact in fp32 below 2^24) is reduced mod nos before the 2*pi
    scaling."""
    p = (torch.arange(n, device=k.device) - n // 2).to(torch.float32)
    k = k.to(torch.float32)
    k_hi = torch.round(k)
    k_lo = k - k_hi
    prod_mod = _mod(k_hi[:, None] * p[None, :], float(nos))   # exact ints
    prod_mod = _mod(prod_mod + k_lo[:, None] * p[None, :], float(nos))
    ang = (-2.0 * math.pi / nos) * prod_mod
    return torch.polar(torch.ones_like(ang), ang)


def dtft2(img: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor, nos: int) -> torch.Tensor:
    """Exact forward transform. img: (..., n, n) [y, x]; kx, ky: (M,) in
    grid units of the nos-point transform. Returns (..., M) complex."""
    n = img.shape[-1]
    ex = _phase(n, nos, kx)  # (M, nx)
    ey = _phase(n, nos, ky)  # (M, ny)
    tmp = torch.einsum("...yx,mx->...ym", img.to(torch.complex64), ex)
    return torch.einsum("...ym,my->...m", tmp, ey)


def dtft2_adjoint(
    samples: torch.Tensor, kx: torch.Tensor, ky: torch.Tensor, n: int, nos: int
) -> torch.Tensor:
    """Exact adjoint: (..., M) samples -> (..., n, n) image [y, x]."""
    ex = torch.conj(_phase(n, nos, kx))  # (M, nx)
    ey = torch.conj(_phase(n, nos, ky))  # (M, ny)
    tmp = torch.einsum("...m,my->...ym", samples.to(torch.complex64), ey)
    return torch.einsum("...ym,mx->...yx", tmp, ex)


def dtft2_adjoint_chunked(
    samples: torch.Tensor,
    kx: torch.Tensor,
    ky: torch.Tensor,
    n: int,
    nos: int,
    chunk: int = 8192,
) -> torch.Tensor:
    """Exact adjoint over chunks of samples, so the (M, n) phase operands and
    the (..., n, M) intermediate never materialize at full M.  Chunks sum
    in order into one accumulator (the JAX package's lax.scan); its
    zero-padded tail contributes exactly zero, so the tail is simply
    shorter here."""
    m = samples.shape[-1]
    acc = samples.new_zeros(samples.shape[:-1] + (n, n), dtype=torch.complex64)
    for m0 in range(0, m, chunk):
        sl = slice(m0, m0 + chunk)
        acc = acc + dtft2_adjoint(samples[..., sl], kx[sl], ky[sl], n, nos)
    return acc


def oracle_adjoint_recon(
    data: torch.Tensor,
    angles: torch.Tensor,
    cfg,
    n: int,
    nro: int,
    chunk: int = 8192,
) -> torch.Tensor:
    """Exact adjoint recon of radial data under the fast path's contract:
    per-cfg SDC (Ram-Lak by default), readout index 0 zeroed (the gridder's
    edge mask excludes it), exact chunked DTFT adjoint, 1/(nro*npe) scale
    (src/tron.cu:532).  data: (..., npe, nro) complex; angles: (npe,).
    Returns (..., n, n) complex coil images (no combine)."""
    from tron_tpu_torch.nufft import sdc_weights

    npe = int(angles.shape[0])
    kr = lattice_radii(nro, nro, data.device)
    kx = (kr[None, :] * torch.cos(angles)[:, None]).reshape(-1)
    ky = (kr[None, :] * torch.sin(angles)[:, None]).reshape(-1)
    wd = drop_readout0(data * sdc_weights(cfg, nro, npe, data.device).to(data.dtype))
    batch = tuple(data.shape[:-2])
    img = dtft2_adjoint_chunked(wd.reshape(batch + (-1,)), kx, ky, n, nro, chunk)
    return img / (nro * npe)
