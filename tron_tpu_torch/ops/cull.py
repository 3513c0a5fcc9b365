"""Per-tile spoke culling (counterpart of `_culling_tables` and of the band
part of `_tile_segments` in `tron_tpu/ops/grid_pallas.py`).

A term of the gridder at pixel (X, Y) needs |r cos t - X| < kw and
|r sin t - Y| < kw, so the pixel lies within sqrt(2)*kw of the spoke's line
through the origin, whatever the radius and its sign.  A tile whose pixel
centres lie within ``d`` of its centre (cx, cy) is therefore reached by a
spoke only if

    |cx sin t - cy cos t| <= d + sqrt(2)*kw + SLACK,

one test for both radius signs, the JAX angular wedge in Cartesian form.
``SLACK`` (one pixel) covers fp32 rounding of the kernel's own positions
and support test, so culling drops only spokes that add no nonzero term.
The CUDA kernel `csrc/grid_seg_radial2d.cu` runs the same test per tile.
"""

from __future__ import annotations

import math

import torch

SLACK = 1.0
TILE = 16  # the CUDA kernel's tile: one 16 x 16 thread block per tile


def reach(kernwidth: float) -> float:
    """Distance beyond the tile's half-diagonal at which a spoke's line can
    still give the tile a nonzero term."""
    return math.sqrt(2.0) * kernwidth + SLACK


def tile_geometry(nxos: int, tile: int = TILE, device=None):
    """Centres (cy, cx) and half-diagonals d of the (tiles_y, tiles_x) tiles
    of an nxos grid, in pixel coordinates relative to the k-space centre.
    Edge tiles are partial when tile does not divide nxos."""
    h = nxos // 2
    lo = torch.arange(0, nxos, tile, device=device)
    hi = torch.clamp(lo + tile, max=nxos) - 1
    centre = 0.5 * (lo + hi).to(torch.float32) - h
    half = 0.5 * (hi - lo).to(torch.float32)
    cy, cx = torch.meshgrid(centre, centre, indexing="ij")
    hy, hx = torch.meshgrid(half, half, indexing="ij")
    return cy, cx, torch.sqrt(hy * hy + hx * hx)


def tile_hits(
    angles: torch.Tensor, nxos: int, kernwidth: float, tile: int = TILE
) -> torch.Tensor:
    """(tiles_y, tiles_x, npe) bool: spoke p can reach tile (i, j)."""
    cy, cx, d = tile_geometry(nxos, tile, angles.device)
    ct = torch.cos(angles.to(torch.float32))
    st = torch.sin(angles.to(torch.float32))
    dist = torch.abs(cx[..., None] * st - cy[..., None] * ct)
    return dist <= (d + reach(kernwidth))[..., None]


def tile_bands(
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    nR: int | None = None,
    tile: int = TILE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each tile's band of sample-plane rows per spoke: the torch twin of
    pass 1 of the gridding kernel (`csrc/grid_radial2d.cu`, ``span_band``
    over the tile's pixel span), in the kernel's float32 arithmetic (the
    kernel may fuse the lattice's multiply-add into one rounding).

    Returns (first, last), each (tiles_y, tiles_x, npe) int64: rows
    first..last of spoke p's plane can give a pixel of tile (i, j) a term;
    first > last when none can.  ``nR`` None grids integer radii (row u at
    radius u - nxos//2, nR = nxos), else the exact lattice of nR rows.  Row
    0 is never in a band."""
    f32 = torch.float32
    h = nxos // 2
    exact = nR is not None
    kw = torch.tensor(kernwidth, dtype=f32)
    ct = torch.cos(angles.to(f32))
    st = torch.sin(angles.to(f32))
    one = torch.ones((), dtype=f32)
    ic = torch.where(ct != 0, one / ct, torch.zeros_like(ct))
    is_ = torch.where(st != 0, one / st, torch.zeros_like(st))
    lo_px = torch.arange(0, nxos, tile, device=angles.device)
    hi_px = torch.clamp(lo_px + tile, max=nxos) - 1
    p0 = (lo_px - h).to(f32)
    p1 = (hi_px - h).to(f32)
    if exact:
        lo = torch.full((1, 1, ct.shape[0]), -float(nxos), dtype=f32)
        hi = torch.full_like(lo, float(nxos))
    else:
        lo = torch.full((1, 1, ct.shape[0]), float(1 - h), dtype=f32)
        hi = torch.full_like(lo, float(nxos - 1 - h))

    def narrow(a0, a1, inv, lo, hi):
        a = (a0 - kw) * inv
        b = (a1 + kw) * inv
        m = inv != 0
        return (torch.where(m, torch.maximum(lo, torch.minimum(a, b)), lo),
                torch.where(m, torch.minimum(hi, torch.maximum(a, b)), hi))

    # x bounds vary along the tile columns (last axis), y along the rows
    lo, hi = narrow(p0[None, :, None], p1[None, :, None], ic, lo, hi)
    lo, hi = narrow(p0[:, None, None], p1[:, None, None], is_, lo, hi)
    if exact:
        lo = torch.minimum(lo, torch.tensor(float(nxos)))
        hi = torch.maximum(hi, torch.tensor(-float(nxos)))
        rpu = torch.tensor(float(nR), dtype=f32) / torch.tensor(float(nxos), dtype=f32)
        hrow = torch.tensor(0.5 * float(nR), dtype=f32)
        first = torch.clamp(torch.floor(lo * rpu + hrow).to(torch.int64) - 1, min=1)
        last = torch.clamp(torch.ceil(hi * rpu + hrow).to(torch.int64) + 1, max=nR - 1)
    else:
        lo = torch.minimum(lo, torch.tensor(float(nxos - 1 - h + 2)))
        hi = torch.maximum(hi, torch.tensor(float(1 - h - 2)))
        first = torch.clamp(torch.floor(lo).to(torch.int64) - 1, min=1 - h) + h
        last = torch.clamp(torch.ceil(hi).to(torch.int64) + 1, max=nxos - 1 - h) + h
    return first, last


def work_items(
    first: torch.Tensor, last: torch.Tensor, item_rows: int
) -> list[list[tuple[int, int]]]:
    """The torch twin of pass 2: each tile's rows, listed spoke by spoke in
    ascending index (rows ascending), cut into items of at most
    ``item_rows`` rows.  Returns, per tile in row-major order, its items as
    (start, stop) ranges over the tile's listed rows; a tile without rows
    has one empty item."""
    rows = torch.clamp(last - first + 1, min=0).reshape(-1, first.shape[-1]).sum(-1)
    return [
        [(s, min(s + item_rows, n)) for s in range(0, n, item_rows)] or [(0, 0)]
        for n in rows.tolist()
    ]


def hit_lists(hits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact each tile's hit spokes to the front in ascending spoke order:
    returns (counts (tiles_y, tiles_x) int64, lists (tiles_y, tiles_x, npe)
    int64 whose first counts[i, j] entries are tile (i, j)'s spokes)."""
    # stable sort of the miss flags puts the hits first, in index order
    lists = torch.argsort((~hits).to(torch.uint8), dim=-1, stable=True)
    return hits.sum(-1), lists
