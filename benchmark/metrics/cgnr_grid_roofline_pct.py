"""cgnr_grid_roofline_pct: the least time one H100 could take for the
gridding a CGNR series needs (the benchmark's frozen `roofline.grid_bound`
of each frame's geometry, niter + 1 times a frame: the right side A^H W d,
then one adjoint an iteration, ``niter`` from the geometry), over the
device time of the default gridding kernel's four passes (B1,
`csrc/grid_radial2d.cu` with `csrc/grid_tiles.cuh`).  The work comes from
the geometry alone: a solver that grids a frame more often reads less.
None where the profile holds no B1 kernel or the geometry no iteration.
Layer: the gridding kernels, `ops/grid_cuda`."""

from benchmark import roofline
from benchmark.reference.nufft import golden_angles

# B1's passes: tile bands, work items, the contraction, the reduction
KERNELS = ("grid_tile_band_kernel", "grid_tile_items_kernel",
           "grid_tile_contract_kernel", "grid_tile_reduce_kernel")


def read(trace):
    g = trace.geometry
    us, _ = trace.kernel_us(KERNELS)
    if us == 0 or not trace.series or g.get("niter", 0) < 1:
        return None
    frame_ms = sum(
        roofline.grid_bound(g["work"], 2 * g["nc"],
                            golden_angles(g["work"], g["skip"] + z * g["slide"]),
                            g["nxos"], g["kernwidth"])[0]
        for z in range(g["nz"]))
    return 100.0 * (g["niter"] + 1) * frame_ms * 1e3 * len(trace.series) / us
