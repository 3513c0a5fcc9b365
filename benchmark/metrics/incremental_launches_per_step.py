"""incremental_launches_per_step: the launch calls the profiler records on
the host (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaLaunchKernelExC`,
`cuLaunchKernelEx`, `cudaGraphLaunch`, one each) that start inside the
port's `tron.incremental_step` spans, over the number of those spans.  A
count: it repeats exactly, and a CUDA graph of the step or a fused launch
lowers it.  None where no such span or no launch was recorded.  Layer: the
incremental scheduler, `recon.incremental_scan`."""

import bisect

from benchmark.trace import LAUNCH_CALLS


def read(trace):
    spans = [(s, e) for s, e, n in trace.host if n == "tron.incremental_step"]
    if not spans or trace.launches == 0:
        return None
    starts = sorted(s for s, _, n in trace.host if n in LAUNCH_CALLS)
    inside = sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
                 for s, e in spans)
    return inside / len(spans)
