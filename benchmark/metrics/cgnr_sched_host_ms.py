"""cgnr_sched_host_ms: the host's time in a CGNR frame's scheduler half:
the time in the port's `tron.frame` spans over the profiled series minus
the time in the `tron.cgnr` spans they hold (each solve,
`solver.cgnr_radial2d`), per frame of the geometry, in ms.  What is left
is `recon.reconstruct_frame`'s `tron.angles` (the frame's angles built on
the card, the host's waits on their scalar uploads included), its
`tron.combine`, the write into the output and the solver's cache key
(`benchmark/idle.py`).  None where no frame holds a solve.  Layer: the
frame scheduler's CGNR half, `recon.reconstruct_frame`."""

from benchmark.idle import sched_frames


def read(trace):
    got = sched_frames(trace)
    if got is None or not trace.frames:
        return None
    frames, solves = got
    total = sum(e - s for s, e, _ in frames) - sum(e - s for s, e, _ in solves)
    return total / trace.frames / 1e3
