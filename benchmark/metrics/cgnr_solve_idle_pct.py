"""cgnr_solve_idle_pct: the card's idle time put down to the CGNR solve,
over the profiled series' span (the first's start to the last's end), in
%: each stretch with no kernel, copy or fill on the card
(`trace.Trace.gaps`) whose innermost port span open on the host when it
began is a `tron.cgnr` or lies inside one (its `tron.toeplitz_psf`,
`tron.cgnr_rhs`, `tron.cgnr_iter`), unless the profiler's own buffer
handling was open then (`benchmark/idle.py`).  None without device
intervals or where no frame holds a solve.  Layer: the device."""

from benchmark.idle import idle_pct


def read(trace):
    return idle_pct(trace, "solve")
