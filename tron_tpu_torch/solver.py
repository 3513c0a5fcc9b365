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
scalar on the host, one synchronisation per iteration.

Across ranks (`parallel/`): with coils sharded the three inner products of an
iteration are summed over each axis of ``reduce_axes``; with spokes sharded
(``spoke_axis``) every CG vector is replicated and A^H W (.) is summed over
that axis.  An axis is a ``parallel.distributed.MeshAxis`` (the JAX package
names the axis of the enclosing shard_map; here the handle carries the
process group).  The stop test reads the reduced scalar, the same bits on
every rank of the group, so all ranks leave the loop together.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.nufft import nufft_adjoint, nufft_adjoint_exact, nufft_forward, sdc_weights
from tron_tpu_torch.ops.degrid import lattice_radii
from tron_tpu_torch.parallel.distributed import MeshAxis, psum


def _weights(
    cfg: ReconConfig, nro: int, npe: int, device, sample_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Ram-Lak (or ideal) weights with readout 0 weighted out: the (nro,)
    row, or with a 0/1 ``sample_mask`` per spoke the (npe_local, nro) table
    that also weights a shard's padded spokes out."""
    w = sdc_weights(cfg, nro, npe, device).clone()
    w[0] = 0
    if sample_mask is not None:
        w = sample_mask.to(w.dtype)[:, None] * w
    return w


def _check_axes(reduce_axes, spoke_axis) -> None:
    for ax in (*reduce_axes, spoke_axis):
        if ax is not None and not isinstance(ax, MeshAxis):
            raise TypeError(f"a mesh axis is given as mesh.axis(name), a MeshAxis; got {ax!r}")
    if spoke_axis is not None and any(ax.name == spoke_axis.name for ax in reduce_axes):
        # image-domain vectors are already replicated along the spoke axis
        raise ValueError(f"spoke_axis {spoke_axis.name!r} must not also be in reduce_axes")


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
    nxos, else "exact".  Readout 0 is weighted out.

    ``npe_total`` and ``sample_mask`` serve spoke-sharded CGNR: ``angles``
    then holds one shard's spokes, the weights come from the frame's spoke
    count ``npe_total``, padded spokes (mask 0) weigh nothing, and the
    shards' kernels sum to the frame's (t is linear over samples)."""
    npe = int(angles.shape[0])
    n = nro // 2
    nxos = int(n * cfg.gridos)
    w2d = _weights(cfg, nro, npe_total or npe, angles.device, sample_mask).expand(npe, nro)
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
    spoke_axis: MeshAxis | None = None,
    npe_total: int | None = None,
    sample_mask: torch.Tensor | None = None,
):
    """(A^H W, A^H W A) of one operator mode, as two functions; ``w`` is the
    (nro,) weight row, or a shard's (npe, nro) table.  ``operators`` as in
    cgnr_radial2d, "auto" resolved by the device of ``w``.  With
    ``spoke_axis`` the spokes are one shard's and A^H W (.) is summed over
    the axis (with "toeplitz": the multiplier, once)."""
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
            # undo the gridder's reference scale (this shard's 1/(nxos*npe))
            return psum(out * (nxos * npe), spoke_axis)

    elif operators == "transpose":
        # the plain forward (backend "jnp"), whose autograd adjoint exists
        cfg_t = dataclasses.replace(cfg, backend="jnp")

        def fwd(x):
            return nufft_forward(x, angles, cfg_t, nro=nro)

        adj = _transpose_adjoint(fwd, img_shape, w.dtype, w.device)

        def AHW(y):
            return psum(adj(w * y), spoke_axis)

    else:
        raise ValueError(f"unknown operators {operators!r}")

    if toeplitz:
        mult = toeplitz_fourier_kernel(
            angles, cfg, nro, npe_total=npe_total, sample_mask=sample_mask
        )
        # after this one sum the iterations need no collective
        mult = psum(mult, spoke_axis)
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
    for a CPU tensor, as JAX picks by platform.

    ``reduce_axes``: the mesh axes the channels are sharded over; the inner
    products are summed over each, so every shard steps with the global
    alpha and beta.  ``spoke_axis``, ``npe_total``, ``sample_mask``:
    spoke-sharded CGNR (`parallel/spoke.py`): ``data`` and ``angles`` hold
    one shard's spokes, the weights come from the frame's ``npe_total``, and
    ``sample_mask`` (0/1 per local spoke) weights the shard's padding out."""
    _check_axes(reduce_axes, spoke_axis)
    niter = cfg.niter if niter is None else niter
    npe, nro = data.shape[-2:]
    n = nro // 2
    img_shape = tuple(data.shape[:-2]) + (n, n)
    # readout 0 (one sample per spoke at the highest |k|, never gridded) is
    # weighted out in every mode, so all modes solve one problem
    w = _weights(cfg, nro, npe_total or npe, data.device, sample_mask).to(data.dtype)
    AHW, normal = _operators(
        angles, cfg, nro, img_shape, w, operators, spoke_axis, npe_total, sample_mask
    )

    def inner(a, bb):
        v = torch.sum(torch.conj(a) * bb).real
        for ax in reduce_axes:
            v = psum(v, ax)
        return v

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
