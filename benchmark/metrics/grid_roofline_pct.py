"""grid_roofline_pct: the least time one H100 could take to grid the frames
of the profiled series (the benchmark's frozen `roofline.grid_bound` of
each frame's geometry, every frame of each series once), over the device
time of the default gridding kernel's four passes (B1,
`csrc/grid_radial2d.cu` with `csrc/grid_tiles.cuh`).  The work comes from
the geometry alone: a gridder that grids a frame twice reads half, and one
that batches frames into fewer calls reads the same.  Layer: the gridding
kernels, `ops/grid_cuda`."""

from benchmark import roofline
from benchmark.reference.nufft import golden_angles

# B1's passes: tile bands, work items, the contraction, the reduction
KERNELS = ("grid_tile_band_kernel", "grid_tile_items_kernel",
           "grid_tile_contract_kernel", "grid_tile_reduce_kernel")


def read(trace):
    g = trace.geometry
    us, _ = trace.kernel_us(KERNELS)
    if us == 0 or not trace.series:
        return None
    series_ms = sum(
        roofline.grid_bound(g["work"], 2 * g["nc"], golden_angles(g["work"], g["skip"] + z * g["slide"]),
                            g["nxos"], g["kernwidth"])[0]
        for z in range(g["nz"]))
    return 100.0 * series_ms * 1e3 * len(trace.series) / us
