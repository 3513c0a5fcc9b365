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


def hit_lists(hits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact each tile's hit spokes to the front in ascending spoke order:
    returns (counts (tiles_y, tiles_x) int64, lists (tiles_y, tiles_x, npe)
    int64 whose first counts[i, j] entries are tile (i, j)'s spokes)."""
    # stable sort of the miss flags puts the hits first, in index order
    lists = torch.argsort((~hits).to(torch.uint8), dim=-1, stable=True)
    return hits.sum(-1), lists
