"""Adjoint radial gridding as a dense separable contraction (counterpart of
`tron_tpu/ops/grid.py`).

For every oversampled grid point (X, Y) and every spoke t, the reference
sums the spoke's samples at integer radii r within kernel width of the
point (`src/tron.cu:465-536`):

    grid[Y, X] = 1/(nxos*npe) * sum_pe sum_r KB(r*cos t - X) KB(r*sin t - Y)
                                             * data[pe, ridx(r)]

Per spoke the weight factorizes, so a chunk of spokes is one matrix product
(U = s * B)^T @ A.  This is the plain version of the CUDA gridding kernels
(`ops/grid_cuda.py`): their CPU twin and their oracle on the card, at each
precision class of the JAX kernels (``matmul_dtype``): "float32" multiplies
the fp32 operands, a bf16 class rounds U and A to bfloat16 through
``torch.bfloat16`` casts and adds the split products of
`precision.class_dot`.
"""

from __future__ import annotations

import torch

from tron_tpu_torch.kernels.kb import kb_kernel
from tron_tpu_torch.ops import cull
from tron_tpu_torch.ops.degrid import lattice_radii
from tron_tpu_torch.ops.precision import class_dot


def _radius_map(nxos: int, nro: int, device=None):
    """Integer grid radii handled by the gridder and their readout indices.

    rr spans [-nxos/2+1, nxos/2-1] (the reference clamps the band to
    nxos/2-1, `src/tron.cu:501`); ridx = trunc(rr*nro/nxos) + nro/2 with
    C truncation semantics (`src/tron.cu:517`).
    """
    rr = torch.arange(nxos, dtype=torch.int32, device=device) - nxos // 2
    ridx = torch.trunc(rr.to(torch.float32) * (nro / nxos)).to(torch.int64) + nro // 2
    valid = (rr > -(nxos // 2)) & (ridx >= 0) & (ridx < nro)
    return rr.to(torch.float32), torch.clamp(ridx, 0, nro - 1), valid


def drop_readout0(data: torch.Tensor) -> torch.Tensor:
    """``data`` (..., nro) with readout 0 zeroed: the sample at radius
    -nxos/2, which the gridding kernels never grid (their band starts at
    row 1) and the dense raw-rows gridder would."""
    return torch.cat([torch.zeros_like(data[..., :1]), data[..., 1:]], dim=-1)


def _grid_dense(
    s: torch.Tensor,
    rr: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    pe_chunk: int,
    matmul_dtype: str = "float32",
) -> torch.Tensor:
    """Real sample planes s (npe, nR, K) at radii rr (nR,) -> (K, nxos, nxos)
    f32 grids, scaled by 1/(nxos*npe), at the class ``matmul_dtype``."""
    npe, nR, K = s.shape
    coord = (torch.arange(nxos, device=s.device) - nxos // 2).to(torch.float32)
    ct = torch.cos(angles.to(torch.float32))
    st = torch.sin(angles.to(torch.float32))
    acc = s.new_zeros((K, nxos, nxos))
    for p0 in range(0, npe, pe_chunk):
        sl = slice(p0, min(p0 + pe_chunk, npe))
        kx = rr[None, :, None] * ct[sl, None, None]            # (P, nR, 1)
        ky = rr[None, :, None] * st[sl, None, None]
        A = kb_kernel(kx - coord, kernwidth, beta)              # (P, nR, nx)
        B = kb_kernel(ky - coord, kernwidth, beta)              # (P, nR, ny)
        U = s[sl].permute(2, 0, 1)[..., None] * B               # (K, P, nR, ny)
        acc += class_dot(U.reshape(K, -1, nxos).transpose(1, 2), A.reshape(-1, nxos), matmul_dtype)
    return acc * (1.0 / (nxos * npe))


def grid_radial2d(
    data: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    pe_chunk: int = 4,
    raw_rows: bool = False,
    matmul_dtype: str = "float32",
) -> torch.Tensor:
    """data: (..., npe, nro) complex radial samples (already density-
    compensated); angles: (npe,).  Returns (..., nxos, nxos) complex centered
    k-space grids, scaled by 1/(nxos*npe) like the reference
    (`src/tron.cu:532`).

    ``raw_rows=True`` grids each readout at its exact radius
    ((ro/nro - 1/2) * nxos, the degridder's radius table `lattice_radii`)
    instead of the trunc-resample onto integer grid radii (identical to the
    default path when nro == nxos is a power of two).  ``matmul_dtype``: the
    precision class (`class_dot`)."""
    *batch, npe, nro = data.shape
    if raw_rows:
        rr = lattice_radii(nro, nxos, data.device)
        ds = data
    else:
        rr, ridx, valid = _radius_map(nxos, nro, data.device)
        ds = torch.index_select(data, -1, ridx) * valid.to(data.dtype)
    nR = rr.shape[0]
    nb = ds[..., 0, 0].numel()
    # complex channels -> interleaved real planes (npe, nR, 2*nb)
    s = torch.view_as_real(ds.reshape(nb, npe, nR)).permute(1, 2, 0, 3)
    s = s.reshape(npe, nR, 2 * nb)
    g = _grid_dense(s, rr, angles, nxos, kernwidth, beta, pe_chunk, matmul_dtype)
    g = g.reshape(nb, 2, nxos, nxos).permute(0, 2, 3, 1).contiguous()
    return torch.view_as_complex(g).reshape(tuple(batch) + (nxos, nxos))


def grid_radial2d_planes_plain(
    planes: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    pe_chunk: int = 8,
    matmul_dtype: str = "float32",
) -> torch.Tensor:
    """Planes form: (npe, nxos, 2C) f32 sample planes (see
    ``grid_cuda.to_sample_planes``; channel 2c is coil c's real part, 2c+1
    its imaginary part) -> (C, nxos, nxos) complex64, scaled by
    1/(nxos*npe), at the class ``matmul_dtype``.  Row 0 (radius -nxos/2) is
    never gridded."""
    npe, nR, K = planes.shape
    rr = (torch.arange(nR, device=planes.device) - nxos // 2).to(torch.float32)
    g = _grid_dense(planes[:, 1:], rr[1:], angles, nxos, kernwidth, beta, pe_chunk, matmul_dtype)
    return _complex_grids(g)


def _complex_grids(g: torch.Tensor) -> torch.Tensor:
    """(2C, n, n) real grids, channel 2c+1 coil c's imaginary part ->
    (C, n, n) complex64."""
    K, ny, nx = g.shape
    return torch.view_as_complex(g.reshape(K // 2, 2, ny, nx).permute(0, 2, 3, 1).contiguous())


def grid_radial2d_planes_culled(
    planes: torch.Tensor,
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    beta: float,
    rad: torch.Tensor | None = None,
    tile: int = cull.TILE,
    seg_chunk: int = 512,
    matmul_dtype: str = "float32",
) -> torch.Tensor:
    """The plain version of B4 (`csrc/grid_seg_radial2d.cu`, the port of
    `_seg_kernel`) in its decomposition: each tile sums the rows of its
    listed segments, the static per-(tile, sign) segments of
    ``cull.tile_segments`` for the spokes that ``cull.seg_hits`` keeps,
    with the planes gridder's separable KB weights.  Same contract as
    ``grid_radial2d_planes_plain``; ``rad`` None grids integer radii (nR ==
    nxos), else row u sits at radius rad[u] (the exact lattice).  Row 0 is
    never gridded.  ``matmul_dtype``: the precision class of each term, A =
    the x-weights, U = samples * y-weights (`class_dot`)."""
    npe, nR, K = planes.shape
    dev = planes.device
    exact = rad is not None
    if rad is None:
        rad = (torch.arange(nR, device=dev) - nxos // 2).to(torch.float32)
    starts, nonempty, seg = cull.tile_segments(nxos, kernwidth, nR if exact else None, tile)
    ti, tj, sign, spoke = torch.nonzero(
        cull.seg_hits(angles, nxos, kernwidth, nonempty, tile), as_tuple=True)
    rows = torch.as_tensor(starts, device=dev).long()[ti, tj, sign][:, None] + torch.arange(
        seg, device=dev)                                                # (S, seg)
    n = -(-nxos // tile)
    px = torch.arange(tile, device=dev) - nxos // 2
    ct = torch.cos(angles.to(torch.float32))
    st = torch.sin(angles.to(torch.float32))
    acc = planes.new_zeros((n * n, K, tile, tile))
    for s0 in range(0, rows.shape[0], seg_chunk):
        sl = slice(s0, s0 + seg_chunk)
        r = rad[rows[sl]][..., None]                                    # (s, seg, 1)
        X = (tj[sl, None] * tile + px).to(torch.float32)[:, None]       # (s, 1, tile)
        Y = (ti[sl, None] * tile + px).to(torch.float32)[:, None]
        wx = kb_kernel(r * ct[spoke[sl], None, None] - X, kernwidth, beta)
        wx = torch.where((rows[sl] == 0)[..., None], 0.0, wx)
        wy = kb_kernel(r * st[spoke[sl], None, None] - Y, kernwidth, beta)
        s = planes[spoke[sl, None], rows[sl]]                           # (s, seg, K)
        if matmul_dtype == "float32":
            part = torch.einsum("srx,sry,srk->skyx", wx, wy, s)
        else:  # per segment: U (rows, (y, k)) against A (rows, x)
            U = (wy[..., None] * s[:, :, None, :]).reshape(s.shape[0], seg, -1)
            part = class_dot(U.transpose(1, 2), wx, matmul_dtype)       # (s, y*k, x)
            part = part.reshape(s.shape[0], tile, K, tile).transpose(1, 2)
        acc.index_add_(0, ti[sl] * n + tj[sl], part)
    g = acc.reshape(n, n, K, tile, tile).permute(2, 0, 3, 1, 4).reshape(K, n * tile, n * tile)
    return _complex_grids(g[:, :nxos, :nxos] * (1.0 / (nxos * npe)))
