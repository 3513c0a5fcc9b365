"""The port's own spans in a traced run, for the per-layer metrics that
read them: `tron_tpu_torch/tracing.py` records them in the profiler's
session, and `trace.Trace.host` holds them by name on the device's clock.
A program that records no such span gives every reader None."""


def durations(trace, name: str) -> list:
    """Per profiled series, the durations (us) of the host spans named
    exactly ``name`` that start inside it."""
    return [[e - s for s, e, n in trace.host if n == name and s0 <= s < s1]
            for s0, s1 in trace.series]


def per_series_ms(trace, name: str):
    """The time in spans named ``name`` inside a series, in ms, the mean
    over the profiled series; None unless every series holds one."""
    per = durations(trace, name)
    if not per or not all(per):
        return None
    return sum(map(sum, per)) / len(per) / 1e3
