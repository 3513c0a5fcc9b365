"""launches_per_frame: the launch calls the profiler records on the host
(`cudaLaunchKernel`, `cuLaunchKernel`, `cudaLaunchKernelExC`,
`cuLaunchKernelEx`, `cudaGraphLaunch`, one each) over the profiled series,
per frame.  A count: it repeats exactly, and a CUDA graph or a fused launch
lowers it.  Layer: the frame scheduler, `recon.recon_frames`."""


def read(trace):
    if trace.launches == 0:
        return None
    return trace.launches / trace.frames
