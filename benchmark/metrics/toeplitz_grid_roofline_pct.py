"""toeplitz_grid_roofline_pct: the least time one H100 could take for the
gridding a CGNR series with the Toeplitz normal operator needs, over the
device time of the default gridding kernel's four passes (B1,
`csrc/grid_radial2d.cu` with `csrc/grid_tiles.cuh`).  A frame grids twice:
its right side A^H W d (the benchmark's frozen `roofline.grid_bound` of the
frame's geometry) and its multiplier, the weights of readouts 1 .. nro - 1
at the doubled radii 2 (ro - nro/2) on the 2 nxos-point grid, one complex
channel (the frozen `roofline.bound` of `roofline.work_of` over those
samples: their planes and the angles in, one grid out).  The iterations
grid nothing.  The work comes from the geometry alone, counting only the
samples the math needs: a build that grids the zero slots of the doubled
readout as well reads less.  None where the profile holds no B1 kernel or
the geometry no iteration.  Layer: the gridding kernels, `ops/grid_cuda`."""

import torch

from benchmark import roofline
from benchmark.reference.nufft import golden_angles

# B1's passes: tile bands, work items, the contraction, the reduction
KERNELS = ("grid_tile_band_kernel", "grid_tile_items_kernel",
           "grid_tile_contract_kernel", "grid_tile_reduce_kernel")


def psf_bound(npe: int, angles: torch.Tensor, nro: int, nxos: int, kw: float) -> float:
    """One multiplier's gridding, in ms: nro - 1 readouts a spoke at the
    doubled radii on a 2 nxos-point grid, one complex channel (K = 2)."""
    n2 = 2 * nxos
    radii = 2.0 * (torch.arange(1, nro, dtype=torch.float64) - nro // 2)
    nbytes = npe * (nro - 1) * 2 * 4 + npe * 4 + n2 * n2 * 8
    return roofline.bound(nbytes, sum(roofline.work_of(radii, angles, n2, 2, kw)))[0]


def read(trace):
    g = trace.geometry
    us, _ = trace.kernel_us(KERNELS)
    if us == 0 or not trace.series or g.get("niter", 0) < 1:
        return None
    frame_ms = 0.0
    for z in range(g["nz"]):
        a = golden_angles(g["work"], g["skip"] + z * g["slide"])
        frame_ms += roofline.grid_bound(g["work"], 2 * g["nc"], a, g["nxos"], g["kernwidth"])[0]
        frame_ms += psf_bound(g["work"], a, g["nro"], g["nxos"], g["kernwidth"])
    return 100.0 * frame_ms * 1e3 * len(trace.series) / us
