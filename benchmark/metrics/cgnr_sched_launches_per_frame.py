"""cgnr_sched_launches_per_frame: the launch calls the profiler records on
the host (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaLaunchKernelExC`,
`cuLaunchKernelEx`, `cudaGraphLaunch`, one each) that start inside the
port's `tron.frame` spans and outside the `tron.cgnr` spans they hold, per
frame of the geometry: a CGNR frame's scheduler half (`benchmark/idle.py`).
A count: it repeats exactly, and a graph of the frame's angles, combine
and write lowers it.  None where no frame holds a solve or no launch was
recorded.  Layer: the frame scheduler's CGNR half,
`recon.reconstruct_frame`."""

import bisect

from benchmark.idle import sched_frames
from benchmark.trace import LAUNCH_CALLS


def read(trace):
    got = sched_frames(trace)
    if got is None or trace.launches == 0 or not trace.frames:
        return None
    starts = sorted(s for s, _, n in trace.host if n in LAUNCH_CALLS)

    def inside(spans):
        return sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
                   for s, e, _ in spans)

    frames, solves = got
    return (inside(frames) - inside(solves)) / trace.frames
