"""cgnr_degrid_roofline_pct: the least time one H100 could take for the
degridding a CGNR series needs (the benchmark's frozen
`roofline.degrid_bound`, clip, on the nxos-point grid, of each frame's
geometry, niter times a frame: one forward an iteration, ``niter`` from the
geometry), over the device time of the degridding kernel (B3,
`csrc/degrid_radial2d.cu`).  The work comes from the geometry alone: a
solver that degrids a frame more often reads less.  None where the profile
holds no B3 kernel or the geometry no iteration.  Layer: the degridding
kernel, `ops/degrid_cuda`."""

from benchmark import roofline
from benchmark.reference.nufft import golden_angles

KERNELS = ("degrid_radial2d_kernel",)


def read(trace):
    g = trace.geometry
    us, _ = trace.kernel_us(KERNELS)
    if us == 0 or not trace.series or g.get("niter", 0) < 1:
        return None
    frame_ms = sum(
        roofline.degrid_bound(g["work"], g["nc"],
                              golden_angles(g["work"], g["skip"] + z * g["slide"]),
                              g["nxos"], g["nro"], g["kernwidth"])[0]
        for z in range(g["nz"]))
    return 100.0 * g["niter"] * frame_ms * 1e3 * len(trace.series) / us
