"""device_idle_pct: the share of the profiled series' span (the first's
start to the last's end) in which no kernel, copy or fill runs on the
card, from the union of the device intervals the profiler records.
Layer: the device."""


def read(trace):
    if not trace.device:
        return None
    w0, w1 = trace.window
    return 100.0 * (1.0 - trace.busy_us() / (w1 - w0))
