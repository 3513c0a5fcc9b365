"""incremental_grid_roofline_pct: the least time one H100 could take for
the gridding a series by the telescoping scheduler needs, over the device
time of the default gridding kernel's four passes (B1,
`csrc/grid_radial2d.cu` with `csrc/grid_tiles.cuh`).  The series grids its
first frame's ``work`` spokes whole, then each later frame's delta: the
``slide`` spokes that leave the window and the ``slide`` that enter it, one
call of 2 slide spokes at their golden angles.  Each call's bound is the
benchmark's frozen `roofline.grid_bound` (2 nc real channels on the nxos
grid), so a delta counts its own grid written once.  The work comes from
the geometry alone: a scheduler that grids each frame whole reads far
less.  None where the profile holds no B1 kernel.  Layer: the gridding
kernels, `ops/grid_cuda`."""

import torch

from benchmark import roofline
from benchmark.reference.nufft import golden_angles

# B1's passes: tile bands, work items, the contraction, the reduction
KERNELS = ("grid_tile_band_kernel", "grid_tile_items_kernel",
           "grid_tile_contract_kernel", "grid_tile_reduce_kernel")


def series_ms(g: dict) -> float:
    """The bound of one series' gridding, in ms: frame 0's window, then
    each later frame's delta of 2 slide spokes."""
    work, slide, K = g["work"], g["slide"], 2 * g["nc"]
    total = roofline.grid_bound(work, K, golden_angles(work, g["skip"]), g["nxos"],
                                g["kernwidth"])[0]
    for z in range(1, g["nz"]):
        pe0 = g["skip"] + (z - 1) * slide
        a = torch.cat([golden_angles(slide, pe0), golden_angles(slide, pe0 + work)])
        total += roofline.grid_bound(2 * slide, K, a, g["nxos"], g["kernwidth"])[0]
    return total


def read(trace):
    us, _ = trace.kernel_us(KERNELS)
    if us == 0 or not trace.series:
        return None
    return 100.0 * series_ms(trace.geometry) * 1e3 * len(trace.series) / us
