"""cgnr_iter_ms: the mean duration of the port's `tron.cgnr_iter` span over
the profiled series: one CGNR iteration of `solver.cgnr_radial2d` (its stop
test's read of the residual on the host first, then the normal operator
and the vector updates, enqueued), in ms.  The host waits on the card at
each stop test, so an iteration's span spans the card's work for the one
before.  None where no such span was recorded.  Layer: the CGNR solver,
`solver.cgnr_radial2d`."""

from benchmark.spans import durations


def read(trace):
    its = [d for per in durations(trace, "tron.cgnr_iter") for d in per]
    return sum(its) / len(its) / 1e3 if its else None
