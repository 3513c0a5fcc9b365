"""Tile geometry of the gridding kernels: torch twins of their list passes.

- ``tile_bands`` and ``work_items``: B1's per-spoke tile bands and item
  cut (`csrc/grid_radial2d.cu`, shared with B5 in `csrc/grid_tiles.cuh`);
- ``tile_segments``, ``seg_hits``, ``seg_entries`` and ``seg_item_rows``:
  B4's static per-(tile, sign) radius segments (the port of
  `_tile_segments`, `tron_tpu/ops/grid_pallas.py:231`), its wedge culling
  (the Cartesian form of `_culling_tables` with ``cull="geom"``, `:317`)
  and its items (`csrc/grid_seg_radial2d.cu`).

Tiles are 16 x 16 (the kernels' thread block), ceil(nxos/16) per axis; an
edge tile may be partial, and B4's geometry then takes the whole 16 x 16
square it lies in, a superset of its pixels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

TILE = 16  # the CUDA kernels' tile: one 16 x 16 thread block per tile
CULL_SLACK = 0.01  # pixels: the wedge test's slack on the projection (kCullSlack)
CULL_SLACK2 = 0.1  # squared pixels: its slack on the squared test (kCullSlack2)
ITEM_ROWS = 256  # L, rows per work item at least (csrc/grid_tiles.cuh kItemRows)
MAX_SLOTS = 4096  # partial slots at most (kMaxSlots)


def tile_bands(
    angles: torch.Tensor,
    nxos: int,
    kernwidth: float,
    nR: int | None = None,
    tile: int = TILE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each tile's band of sample-plane rows per spoke: the torch twin of
    pass 1 of the gridding kernel (`csrc/grid_tiles.cuh:tile_list`,
    ``span_band`` over the tile's pixel span), in the kernel's float32
    arithmetic (the kernel may fuse the lattice's multiply-add into one
    rounding).

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


def item_ranges(rows: list[int], item_rows: int) -> list[list[tuple[int, int]]]:
    """The torch twin of pass 2's cut (`csrc/grid_tiles.cuh`): each tile's
    ``rows`` listed rows cut into items of at most ``item_rows`` rows, as
    (start, stop) ranges in list order; a tile without rows has one empty
    item (which writes its zeros)."""
    return [[(s, min(s + item_rows, n)) for s in range(0, n, item_rows)] or [(0, 0)] for n in rows]


def work_items(
    first: torch.Tensor, last: torch.Tensor, item_rows: int
) -> list[list[tuple[int, int]]]:
    """B1's items: each tile's band rows, listed spoke by spoke in ascending
    index (rows ascending), cut by ``item_ranges``; per tile in row-major
    order."""
    rows = torch.clamp(last - first + 1, min=0).reshape(-1, first.shape[-1]).sum(-1)
    return item_ranges(rows.tolist(), item_rows)


def _segment_pad(kernwidth: float, row_scale: float, odd_lattice: bool) -> int:
    """Rows by which B4 widens JAX's segment bands.  JAX's band of a tile
    is |r| in [rmin - kw, rmax + kw] in rows, floor and ceil of its ends
    widened by one row each; a term needs only |r| within sqrt(2) kw of
    the tile (|r c - X| < kw and |r s - Y| < kw), so the band is
    conservative while (sqrt(2) - 1) kw stays within those two rows of
    slack, which holds at every width JAX runs (kw <= 3 at gridos >= 1.5).
    Beyond that widen, and an odd-row lattice, whose rows sit half a row
    off the integers, counts its half row in the excess."""
    excess = (math.sqrt(2.0) - 1.0) * kernwidth / row_scale + (0.5 if odd_lattice else 0.0) + 0.05
    return max(0, math.ceil(excess) - 2)


@functools.cache
def tile_segments(
    nxos: int, kernwidth: float, nR: int | None = None, tile: int = TILE
) -> tuple[np.ndarray, np.ndarray, int]:
    """Static per-(tile, sign) radius segments of B4: `_tile_segments` at
    square ``tile`` tiles, extended to ceil(nxos/tile) tiles per axis (an
    edge tile takes its whole square) and to any lattice; equal to JAX's
    integer for integer wherever JAX runs (nR even).

    Sample-plane row u sits at radius (u - nR/2) * row_scale: integer radii
    (``nR`` None: nR = nxos, row_scale 1) or the exact lattice (row_scale =
    nxos/nR).  With hr = nR//2, a band of radius magnitudes m in rows
    (offsets from the centre row) lists positive-side rows hs + m, hs =
    nR - hr the first row of radius >= 0, and negative-side rows hr - m:
    on an even lattice m >= 1 there (r = 0 is the positive side's), on an
    odd one m >= 0 (row hr sits at -row_scale/2).  Both sides hold hr rows
    that are ever gridded (row 0 never is), so a segment of at most hr rows
    fits each.  Returns (starts, nonempty, seg): starts (tiles_y, tiles_x,
    2) int32, the first row of sign s's segment of seg rows (s = 0: the
    positive side; s = 1: the negative), and nonempty (tiles_y, tiles_x, 2)
    bool, whether the sign's band holds any row.  A segment's rows outside
    the band have zero KB weight for every pixel of the tile; the two
    segments of a tile share no row of its band.  Host-side, cached per
    geometry."""
    exact = nR is not None
    if nR is None:
        nR = nxos
    row_scale = nxos / nR if exact else 1.0
    odd = nR % 2 == 1
    pad = _segment_pad(kernwidth, row_scale, odd)
    h = nxos // 2
    hr = nR // 2
    hs = nR - hr
    n = -(-nxos // tile)
    bands = np.zeros((n, n, 2), np.int64)
    nonempty = np.zeros((n, n, 2), bool)
    for i in range(n):
        y0, y1 = i * tile - h, (i + 1) * tile - 1 - h
        for j in range(n):
            x0, x1 = j * tile - h, (j + 1) * tile - 1 - h
            dx = 0.0 if x0 <= 0 <= x1 else min(abs(x0), abs(x1))
            dy = 0.0 if y0 <= 0 <= y1 else min(abs(y0), abs(y1))
            rmin = (dx * dx + dy * dy) ** 0.5
            rmax = max((xx * xx + yy * yy) ** 0.5 for xx in (x0, x1) for yy in (y0, y1))
            lo = max(0, int(np.floor((rmin - kernwidth) / row_scale)) - 1 - pad)
            hi = min(hr - 1, int(np.ceil((rmax + kernwidth) / row_scale)) + 1 + pad)
            bands[i, j] = (lo, hi)
            nonempty[i, j, 0] = lo <= hi
            nonempty[i, j, 1] = hi >= (lo if odd else max(lo, 1))
    blen = bands[..., 1] - bands[..., 0]
    seg = min(hr, -(-int(blen.max() + 1) // 8) * 8)
    starts = np.zeros((n, n, 2), np.int32)
    for i in range(n):
        for j in range(n):
            lo, hi = int(bands[i, j, 0]), int(bands[i, j, 1])
            starts[i, j, 0] = min(hs + lo, nR - seg)
            # the negative segment may reach up into the positive side's
            # rows below the band (m < lo), never into the band
            end_max = hs + lo - 1
            starts[i, j, 1] = max(0, min(hr - hi, end_max - seg + 1))
    return starts, nonempty, seg


def wedge_margin(kernwidth: float, tile: int = TILE) -> float:
    """The distance from a tile's centre within which a spoke's line must
    pass to reach it: JAX's half-diagonal + kw + 2, or half-diagonal +
    sqrt(2) kw + 1 where that is larger (kw > 3.4), so that it always
    covers a term's reach of sqrt(2) kw."""
    return tile / math.sqrt(2.0) + max(kernwidth + 2.0, math.sqrt(2.0) * kernwidth + 1.0)


def _tile_centres(nxos: int, tile: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cy, cx), each (n, n) float32: the centres of the whole tile squares,
    (i + 0.5) tile - nxos//2, as JAX's wedge takes them."""
    n = -(-nxos // tile)
    centre = (torch.arange(n, device=device) * tile + tile // 2 - nxos // 2).to(torch.float32)
    return torch.meshgrid(centre, centre, indexing="ij")


def seg_hits(
    angles: torch.Tensor, nxos: int, kernwidth: float, nonempty, tile: int = TILE
) -> torch.Tensor:
    """(tiles_y, tiles_x, 2, npe) bool: spoke p's sign-s segment is listed
    for tile (i, j).  The torch twin of pass 1 of B4
    (`csrc/grid_seg_radial2d.cu:seg_list`), in its float32 arithmetic.

    JAX keeps a spoke when the angular distance from its direction (s = 0)
    or the opposite one (s = 1) to the tile centre's is at most asin(m /
    dist) (every spoke where dist <= m), m = ``wedge_margin``.  In
    Cartesian form, with proj = cos t * cx + sin t * cy: +-proj >= sqrt(
    dist^2 - m^2).  The kernel tests a^2 >= dist^2 - m^2 - ``CULL_SLACK2``
    with a = +-proj + ``CULL_SLACK`` >= 0: a superset of JAX's hits that
    covers float32 rounding on both sides (JAX's angles are good to ~1e-6
    rad, ~1e-3 pixel here; the squares to ~0.01 square pixel) and widens a
    far tile's wedge by ~1 %.  Signs whose band is empty (``nonempty``)
    list nothing."""
    cy, cx = _tile_centres(nxos, tile, angles.device)
    m = torch.tensor(wedge_margin(kernwidth, tile), dtype=torch.float32)
    d2m = (cx * cx + cy * cy - m * m)[..., None]
    ct = torch.cos(angles.to(torch.float32))
    st = torch.sin(angles.to(torch.float32))
    proj = ct * cx[..., None] + st * cy[..., None]
    a = proj + CULL_SLACK
    b = CULL_SLACK - proj
    lim = d2m - CULL_SLACK2
    pos = (d2m <= 0) | ((a >= 0) & (a * a >= lim))
    neg = (d2m <= 0) | ((b >= 0) & (b * b >= lim))
    hits = torch.stack([pos, neg], dim=-2)
    return hits & torch.as_tensor(nonempty, device=angles.device)[..., None]


def seg_entries(hits: torch.Tensor, starts) -> list[list[tuple[int, int]]]:
    """Each tile's listed segments in the kernel's order, spokes ascending
    and the negative-radius segment of a spoke first: per tile in row-major
    order, a list of (spoke, first plane row)."""
    starts = np.asarray(starts)
    out = []
    ny, nx = hits.shape[:2]
    h = hits.cpu().numpy()
    for i in range(ny):
        for j in range(nx):
            ent = []
            for p in range(h.shape[-1]):
                for s in (1, 0):
                    if h[i, j, s, p]:
                        ent.append((p, int(starts[i, j, s])))
            out.append(ent)
    return out


def seg_item_rows(seg: int, item_rows: int = ITEM_ROWS) -> int:
    """B4's L at the least: ``item_rows`` rounded up to whole segments."""
    return -(-item_rows // seg) * seg


def seg_slots(npe: int, nxos: int, kernwidth: float, nR: int | None = None,
              tile: int = TILE) -> int:
    """B4's partial slots, from its own rows estimate: each listed (tile,
    sign) holds seg rows per spoke in its wedge, about npe * delta / pi
    spokes + 1 for angles spread over the circle, delta = asin(m / dist) (pi
    within m).  Pass 2 needs 2 R / L slots for R rows; the estimate gets
    25 % more, at most MAX_SLOTS (beyond that pass 2 lengthens the items)."""
    _, nonempty, seg = tile_segments(nxos, kernwidth, nR, tile)
    per_spoke, fixed = _wedge_sums(nxos, kernwidth, tile, nonempty.tobytes())
    est = seg * (npe * per_spoke + fixed)
    return max(1, min(MAX_SLOTS, math.ceil(2.5 * est / seg_item_rows(seg))))


@functools.cache
def _wedge_sums(nxos: int, kernwidth: float, tile: int, nonempty: bytes) -> tuple[float, int]:
    """(sum of delta / pi, count) over the listed-sign (tile, sign) pairs."""
    ne = np.frombuffer(nonempty, bool).reshape(-1, 2)
    cy, cx = (c.double().numpy().ravel() for c in _tile_centres(nxos, tile))
    dist = np.hypot(cx, cy)
    m = wedge_margin(kernwidth, tile)
    delta = np.where(dist <= m, np.pi, np.arcsin(np.minimum(1.0, m / np.maximum(dist, 1e-6))))
    return float((ne * (delta / np.pi)[:, None]).sum()), int(ne.sum())
