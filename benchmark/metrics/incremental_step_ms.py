"""incremental_step_ms: the mean duration of the port's
`tron.incremental_step` span over the profiled series: one telescoped
frame's delta in `recon.incremental_scan` (the leaving, negated, and the
entering spokes' planes and their angles concatenated, their gridding call
and the scaled add into the carried grid), as the host enqueues it, with
the angles' waits on the card inside it, in ms.  A scan's first frame,
gridded whole, opens no step.  None where no such span was recorded.
Layer: the incremental scheduler, `recon.incremental_scan`."""

from benchmark.spans import durations


def read(trace):
    steps = [d for per in durations(trace, "tron.incremental_step") for d in per]
    return sum(steps) / len(steps) / 1e3 if steps else None
