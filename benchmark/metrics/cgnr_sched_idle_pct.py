"""cgnr_sched_idle_pct: the card's idle time put down to a CGNR frame's
scheduler half, over the profiled series' span (the first's start to the
last's end), in %: each stretch with no kernel, copy or fill on the card
(`trace.Trace.gaps`) whose innermost port span open on the host when it
began lies inside a `tron.frame` and outside its `tron.cgnr` (the
frame's `tron.angles`, its `tron.combine`, or the frame itself), unless
the profiler's own buffer handling was open then (`benchmark/idle.py`).
None without device intervals or where no frame holds a solve.  Layer:
the device."""

from benchmark.idle import idle_pct


def read(trace):
    return idle_pct(trace, "scheduler")
