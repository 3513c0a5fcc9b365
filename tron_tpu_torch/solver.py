"""Iterative CGNR reconstruction (counterpart of `tron_tpu/solver.py`).

Solves the Ram-Lak-weighted least-squares problem of Knopp et al. 2007,

    min_x || W^(1/2) (A x - b) ||^2      =>      A^H W A x = A^H W b

with A = nufft_forward and W = diag(ramlak), readout 0 weighted out.  Three
operator modes, each a true adjoint pair or its normal operator:

  * "pair": the two CUDA kernels, the clip-mode degrid and the gridder (its
    exact-lattice mode when nro != nxos), which are one adjoint pair;
  * "transpose": the adjoint of the plain forward by autograd, as JAX takes
    `jax.linear_transpose` of its dense forward (PyTorch's complex vjp is
    already A^H v, where JAX needs conj(A^T conj v));
  * "toeplitz": the normal operator as a Toeplitz-embedded FFT convolution.

The loop stops where the JAX package's `lax.while_loop` stops
(`rs > rtol^2 <b, b>` and k < niter); its stop test reads one device
scalar on the host, one synchronisation per iteration.  The multi-device
arguments (``reduce_axes``, ``spoke_axis``, ``npe_total``, ``sample_mask``)
are still to port (ROADMAP A17) and raise.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.nufft import nufft_adjoint, nufft_adjoint_exact, nufft_forward, sdc_weights
from tron_tpu_torch.ops.degrid import lattice_radii


def _multi_device_unported(npe_total=None, sample_mask=None, reduce_axes=(), spoke_axis=None):
    if npe_total is not None or sample_mask is not None or reduce_axes or spoke_axis is not None:
        raise NotImplementedError(
            "multi-device CGNR (reduce_axes, spoke_axis, npe_total, sample_mask) is not "
            "ported yet (ROADMAP A17)"
        )


def _weights(cfg: ReconConfig, nro: int, npe: int, device) -> torch.Tensor:
    """Ram-Lak (or ideal) weights with readout 0 weighted out."""
    w = sdc_weights(cfg, nro, npe, device).clone()
    w[0] = 0
    return w


def toeplitz_fourier_kernel(
    angles: torch.Tensor,
    cfg: ReconConfig,
    nro: int,
    method: str = "auto",
    npe_total: int | None = None,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fourier multiplier of the Toeplitz-embedded normal operator,
    fft2(ifftshift(t)) of shape (2n, 2n) with n = nro // 2 and

        t[d] = sum_m w_m exp(+2i pi k_m . d / nro).

    ``method``: "nufft" grids the weights at doubled image size with the
    fast adjoint (the doubled-frequency identity holds only at gridos 2);
    "exact" sums the DTFT adjoint in chunks; "auto" is "nufft" when nro ==
    nxos, else "exact".  Readout 0 is weighted out."""
    _multi_device_unported(npe_total, sample_mask)
    npe = int(angles.shape[0])
    n = nro // 2
    nxos = int(n * cfg.gridos)
    w2d = _weights(cfg, nro, npe, angles.device)[None, :].expand(npe, nro)
    if method == "auto":
        method = "nufft" if nro == nxos else "exact"
        if method == "exact" and n > 64:
            warnings.warn(
                f"toeplitz_fourier_kernel: gridos={cfg.gridos} != 2 forces the exact-DTFT "
                f"PSF kernel (O((2n)^2 M) flops at n={n}); expect a slow per-frame "
                "precompute; use gridos=2 for the fast gridded kernel",
                stacklevel=2,
            )
    elif method == "nufft" and nro != nxos:
        # the doubled-frequency embedding holds only at gridos == 2: at any
        # other osf the even-slot samples land at the wrong doubled
        # frequencies, so refuse rather than return a wrong kernel
        raise ValueError(
            f"toeplitz_fourier_kernel(method='nufft') requires gridos == 2 "
            f"(got gridos={cfg.gridos}: nxos={nxos} != nro={nro}); use "
            "method='exact' or 'auto'"
        )

    if method == "exact":
        from tron_tpu_torch.oracle.dtft import dtft2_adjoint_chunked

        kr = lattice_radii(nro, nro, angles.device)
        kx = (kr[None, :] * torch.cos(angles)[:, None]).reshape(-1)
        ky = (kr[None, :] * torch.sin(angles)[:, None]).reshape(-1)
        t = dtft2_adjoint_chunked(w2d.to(torch.complex64).reshape(-1), kx, ky, 2 * n, nro)
    else:
        w2 = torch.zeros((npe, 2 * nro), dtype=torch.complex64, device=angles.device)
        w2[:, ::2] = w2d
        # undo the gridder's 1/(nxos'*npe) scale at the doubled geometry
        # (nro' = 2*nro, so nxos' = int(nro * gridos))
        t = nufft_adjoint(w2, angles, cfg, apply_sdc=False) * (int(nro * cfg.gridos) * npe)
    return torch.fft.fft2(torch.fft.ifftshift(t, dim=(-2, -1)))


def toeplitz_apply(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """Apply the Toeplitz-embedded normal operator: zero-pad the (..., n, n)
    image into the corner of a (2n, 2n) grid, multiply in Fourier space,
    crop back."""
    n = x.shape[-1]
    xp = x.new_zeros(x.shape[:-2] + (2 * n, 2 * n), dtype=torch.complex64)
    xp[..., :n, :n] = x
    y = torch.fft.ifft2(torch.fft.fft2(xp) * mult)
    return y[..., :n, :n].to(x.dtype)


def _transpose_adjoint(fwd, img_shape, dtype, device):
    """z -> A^H z for the linear map fwd, by one vjp at zero: PyTorch's
    complex vjp is the conjugate-transpose product."""
    _, vjp = torch.func.vjp(fwd, torch.zeros(img_shape, dtype=dtype, device=device))
    return lambda z: vjp(z)[0]


def _operators(
    angles: torch.Tensor,
    cfg: ReconConfig,
    nro: int,
    img_shape: tuple,
    w: torch.Tensor,
    operators: str,
):
    """(A^H W, A^H W A) of one operator mode, as two functions; ``w`` is the
    (nro,) weight row.  ``operators`` as in cgnr_radial2d, "auto" resolved
    by the device of ``w``."""
    npe = int(angles.shape[0])
    nxos = int((nro // 2) * cfg.gridos)
    if operators == "auto" and cfg.toeplitz:
        operators = "toeplitz"
    toeplitz = operators == "toeplitz"
    if operators in ("auto", "toeplitz"):
        operators = "pair" if w.device.type == "cuda" else "transpose"

    if operators == "pair":
        # the clip-mode forward is the exact transpose of the gridding
        # adjoint; at gridos != 2 the trunc-resample of the default adjoint
        # is a poor forward model, so the pair takes the exact lattice
        def fwd(x):
            return nufft_forward(x, angles, cfg, nro=nro, wrap=False)

        def AHW(y):
            if nro == nxos:
                out = nufft_adjoint(w * y, angles, cfg, apply_sdc=False)
            else:
                out = nufft_adjoint_exact(w * y, angles, cfg)
            return out * (nxos * npe)  # undo the gridder's reference scale

    elif operators == "transpose":
        # the plain forward (backend "jnp"), whose autograd adjoint exists
        cfg_t = dataclasses.replace(cfg, backend="jnp")

        def fwd(x):
            return nufft_forward(x, angles, cfg_t, nro=nro)

        adj = _transpose_adjoint(fwd, img_shape, w.dtype, w.device)

        def AHW(y):
            return adj(w * y)

    else:
        raise ValueError(f"unknown operators {operators!r}")

    if toeplitz:
        mult = toeplitz_fourier_kernel(angles, cfg, nro)
        return AHW, lambda x: toeplitz_apply(x, mult)
    return AHW, lambda x: AHW(fwd(x))


def cgnr_radial2d(
    data: torch.Tensor,
    angles: torch.Tensor,
    cfg: ReconConfig,
    niter: int | None = None,
    rtol: float = 1e-6,
    reduce_axes: tuple = (),
    operators: str = "auto",
    spoke_axis: str | None = None,
    npe_total: int | None = None,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """data: (..., npe, nro) -> image estimate (..., n, n).

    ``operators``: "pair" (the kernel pair), "transpose" (autograd adjoint
    of the plain forward), "toeplitz" (Toeplitz normal operator; the right
    side A^H W b still uses the fast adjoint once), or "auto": "toeplitz"
    when cfg.toeplitz is set, else "pair" for a CUDA tensor and "transpose"
    for a CPU tensor, as JAX picks by platform."""
    _multi_device_unported(npe_total, sample_mask, reduce_axes, spoke_axis)
    niter = cfg.niter if niter is None else niter
    npe, nro = data.shape[-2:]
    n = nro // 2
    img_shape = tuple(data.shape[:-2]) + (n, n)
    # readout 0 (one sample per spoke at the highest |k|, never gridded) is
    # weighted out in every mode, so all modes solve one problem
    w = _weights(cfg, nro, npe, data.device).to(data.dtype)
    AHW, normal = _operators(angles, cfg, nro, img_shape, w, operators)

    def inner(a, bb):
        return torch.sum(torch.conj(a) * bb).real

    b = AHW(data)
    thresh = rtol * rtol * inner(b, b)
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = inner(r, r)
    k = 0
    while k < niter and bool(rs > thresh):
        Ap = normal(p)
        alpha = rs / torch.clamp(inner(p, Ap), min=1e-30)
        x = x + alpha.to(x.dtype) * p
        r = r - alpha.to(r.dtype) * Ap
        rs_new = inner(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta.to(p.dtype) * p
        rs = rs_new
        k += 1
    return x


def cgnr_or_adjoint(data: torch.Tensor, angles: torch.Tensor, cfg: ReconConfig) -> torch.Tensor:
    """Dispatch like the reference program (`src/tron.cu:753-758`)."""
    if cfg.niter > 0:
        return cgnr_radial2d(data, angles, cfg)
    return nufft_adjoint(data, angles, cfg)
