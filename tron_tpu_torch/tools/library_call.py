"""The library formulation of the gridding and degridding kernels: one sparse
matrix product.

Gridding and degridding are fixed sparse linear maps.  Degridding (B3,
`csrc/degrid_radial2d.cu`) is samples = A @ grid, with A the Kaiser-Bessel
interpolation matrix (a row per sample, a column per grid pixel, the
(int(2kw)+1)^2 separable KB weights of the sample's neighbours); gridding
(B1/B2/B4/B5) is grid = A^T @ samples, scaled by 1/(nxos*npe).  Stored as
CSR, the matrix turns either into one ``torch.sparse.mm``, which on the
card is cuSPARSE's SpMM: the sparse-matrix NUFFT of Fessler's IRT, whose
MATLAB code the reference vendors under `contrib/irt/`.

This module is a yardstick: ``chip_smoke.py`` [library] and
``tools.kbench --library`` time the call beside the hand-written kernels
(`library_ms`).  Nothing on any path of the port imports it.

- ``interp_matrix`` builds the matrix on the tensors' device, with the
  plain versions' conventions: the fp32 ``kb_kernel`` products of
  `kernels/kb.py`; for gridding (``transpose=True``, a row per grid pixel)
  sample planes as ``grid_cuda.to_sample_planes`` lays them out (the radius
  map and edge mask already applied), row 0 never gridded, integer radii or
  the exact lattice's radii, footprints clipped at the grid edge; for
  degridding the readouts on ``lattice_radii`` and the gather's neighbours
  (`ops/degrid.py`), wrapped or clipped.  The transpose is built as a CSR
  of its own: ``sparse.mm(A.t(), x)`` would take cuSPARSE's transposed
  algorithm, which accumulates with atomics.
- ``grid_library`` and ``degrid_library`` are exactly one ``torch.sparse.mm``
  each, on the kernels' own input layout (sample planes (npe*nR, 2C) or grid
  planes (n^2, 2C) f32); ``grid_output`` and ``degrid_output`` relayout the
  result, outside any timed call.
"""

from __future__ import annotations

import warnings

import torch

from tron_tpu_torch.kernels.kb import kb_kernel
from tron_tpu_torch.ops.degrid import lattice_radii


def _csr(rows, cols, vals, shape) -> torch.Tensor:
    """COO triplets -> CSR, duplicates summed (a wrapped footprint can hold
    one pixel twice on a tiny grid), with int32 indices (torch's default,
    int64, would add 4 bytes per nonzero to what cuSPARSE reads)."""
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                  check_invariants=False).coalesce()
    with warnings.catch_warnings():  # "sparse CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        csr = coo.to_sparse_csr()
        return torch.sparse_csr_tensor(
            csr.crow_indices().to(torch.int32), csr.col_indices().to(torch.int32),
            csr.values(), shape, check_invariants=False,
        )


def _neighbours(pos: torch.Tensor, first: torch.Tensor, count: int, kernwidth, beta):
    """Candidate integer coordinates first + k, k < count, of each position
    and their fp32 KB weights against it: (..., count) each."""
    u = first[..., None] + torch.arange(count, device=pos.device)
    return u, kb_kernel(u.to(torch.float32) - pos[..., None], kernwidth, beta)


def interp_matrix(
    angles: torch.Tensor,
    n: int,
    nR_or_radii,
    kernwidth: float,
    beta: float,
    wrap: bool = False,
    transpose: bool = False,
) -> torch.Tensor:
    """The KB interpolation matrix of an n x n grid and the spokes at
    ``angles`` (npe,), on ``angles``' device.

    ``transpose=False`` (degridding, B3): ``nR_or_radii`` is nro, the
    readouts sit on ``lattice_radii(nro, n)``; (npe*nro, n^2), a row per
    sample p*nro + u, a column per pixel y*n + x, ``wrap`` or clip.

    ``transpose=True`` (gridding): ``nR_or_radii`` is nR, the rows of sample
    planes on integer radii u - n//2 (nR == n), or a (nR,) tensor of row
    radii (the exact lattice); (n^2, npe*nR), scaled by 1/(n*npe), row 0 of
    every spoke left out, clipped at the grid edge (JAX's kernels clip).

    Only the nonzero weights are stored (a KB weight is nonzero exactly
    inside its support): a ``torch.sparse_csr_tensor`` of float32 values
    with int32 indices."""
    dev = angles.device
    npe = angles.shape[0]
    ct = torch.cos(angles.to(torch.float32))
    st = torch.sin(angles.to(torch.float32))
    noff = int(2 * kernwidth) + 1
    if not transpose:
        nro = int(nR_or_radii)
        kr = lattice_radii(nro, n, dev)
        xs = kr[None, :] * ct[:, None] + n // 2                    # (npe, nro), as the gather
        ys = kr[None, :] * st[:, None] + n // 2
        xu, wx = _neighbours(xs, torch.ceil(xs - kernwidth).to(torch.int64), noff, kernwidth, beta)
        yu, wy = _neighbours(ys, torch.ceil(ys - kernwidth).to(torch.int64), noff, kernwidth, beta)
        if not wrap:
            wx = wx * ((xu >= 0) & (xu < n))
            wy = wy * ((yu >= 0) & (yu < n))
        w = wy[..., :, None] * wx[..., None, :]                   # (npe, nro, y, x)
        col = torch.remainder(yu, n)[..., :, None] * n + torch.remainder(xu, n)[..., None, :]
        row = torch.arange(npe * nro, device=dev).reshape(npe, nro)[..., None, None]
        keep = w != 0
        return _csr(row.expand_as(col)[keep], col[keep], w[keep], (npe * nro, n * n))
    if wrap:
        raise ValueError("the gridding kernels clip at the grid edge: wrap=False only")
    if isinstance(nR_or_radii, torch.Tensor):
        rad = nR_or_radii.to(dev, torch.float32)
    else:
        rad = (torch.arange(int(nR_or_radii), device=dev) - n // 2).to(torch.float32)
    nR = rad.shape[0]
    # the planes gridder's weights kb(r*c - X) over centred pixels X; a
    # margin of one candidate each side, kept only where the weight is not 0
    kx = rad[None, :] * ct[:, None]                               # (npe, nR)
    ky = rad[None, :] * st[:, None]
    xu, wx = _neighbours(kx, torch.ceil(kx - kernwidth).to(torch.int64) - 1, noff + 2,
                         kernwidth, beta)
    yu, wy = _neighbours(ky, torch.ceil(ky - kernwidth).to(torch.int64) - 1, noff + 2,
                         kernwidth, beta)
    xu, yu = xu + n // 2, yu + n // 2                              # pixel indices
    wx = wx * ((xu >= 0) & (xu < n))
    wy = wy * ((yu >= 0) & (yu < n))
    wx[:, 0] = 0                                                   # row 0 is never gridded
    w = (wy[..., :, None] * wx[..., None, :]) * (1.0 / (n * npe))
    pix = yu[..., :, None] * n + xu[..., None, :]
    sample = torch.arange(npe * nR, device=dev).reshape(npe, nR)[..., None, None]
    keep = w != 0
    return _csr(pix[keep], sample.expand_as(pix)[keep], w[keep], (n * n, npe * nR))


def grid_library(planes: torch.Tensor, AT: torch.Tensor) -> torch.Tensor:
    """Gridding as one sparse product: sample planes (npe, nR, 2C) f32 (a
    view of them as (npe*nR, 2C)) through ``AT`` = ``interp_matrix(...,
    transpose=True)`` -> (n^2, 2C) f32."""
    return torch.sparse.mm(AT, planes.reshape(-1, planes.shape[-1]))


def degrid_library(gplanes: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Degridding as one sparse product: grid planes (n, n, 2C) f32
    (``degrid_cuda.to_grid_planes``) through ``A`` = ``interp_matrix(...)``
    -> (npe*nro, 2C) f32."""
    return torch.sparse.mm(A, gplanes.reshape(-1, gplanes.shape[-1]))


def grid_output(out: torch.Tensor, n: int) -> torch.Tensor:
    """``grid_library``'s (n^2, 2C) -> (C, n, n) complex64, the gridding
    wrappers' layout."""
    return torch.view_as_complex(out.reshape(n, n, -1, 2).permute(2, 0, 1, 3).contiguous())


def degrid_output(out: torch.Tensor, npe: int, nro: int) -> torch.Tensor:
    """``degrid_library``'s (npe*nro, 2C) -> (C, npe, nro) complex64, the
    degridding wrapper's layout."""
    return torch.view_as_complex(out.reshape(npe, nro, -1, 2).permute(2, 0, 1, 3).contiguous())


def matrix_bytes(A: torch.Tensor) -> int:
    """Bytes of a CSR matrix: values, column indices and row pointers."""
    return sum(t.numel() * t.element_size()
               for t in (A.values(), A.col_indices(), A.crow_indices()))


def spmm_bytes(A: torch.Tensor, k: int) -> int:
    """Bytes one product must move: the matrix read once, its (ncols, k) f32
    operand read once, the (nrows, k) f32 result written once."""
    nrows, ncols = A.shape
    return matrix_bytes(A) + 4 * k * (ncols + nrows)
