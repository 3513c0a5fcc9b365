"""degrid_roofline_pct: the least time one H100 could take to degrid the
frames of the profiled series (the benchmark's frozen `roofline.degrid_bound`
of each frame's geometry, every frame of each series once), over the device
time of the degridding kernel (B3, `csrc/degrid_radial2d.cu`), its
float32 wrap-edge launches included where a class makes them.  The work
comes from the geometry alone: a degridder that runs a frame twice reads
half.  None where the profile holds no B3 kernel.  Layer: the degridding
kernel, `ops/degrid_cuda`."""

import collections

from benchmark import roofline
from benchmark.reference.nufft import golden_angles

KERNELS = ("degrid_radial2d_kernel",)


def read(trace):
    g = trace.geometry
    us, _ = trace.kernel_us(KERNELS)
    if us == 0 or not trace.series:
        return None
    # a forward series has every frame on one angle set (slide 0)
    skips = collections.Counter(g["skip"] + z * g["slide"] for z in range(g["nz"]))
    series_ms = sum(
        k * roofline.degrid_bound(g["work"], g["nc"], golden_angles(g["work"], s), g["nxos"],
                                  g["nro"], g["kernwidth"])[0]
        for s, k in skips.items())
    return 100.0 * series_ms * 1e3 * len(trace.series) / us
