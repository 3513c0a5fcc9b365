"""host_lead_ms: per profiled series, the time from the start of the
harness's span around `recon_radial2d` to the start of the first kernel on
the device (copies and fills do not count): the host relayout of the input
and its upload, which the card waits for.  The mean over the profiled
series, in ms.  Layer: the host driver, `recon.recon_radial2d`."""

import bisect


def read(trace):
    starts = sorted(s for s, _, _ in trace.kernels())
    leads = []
    for s0, s1 in trace.series:
        k = bisect.bisect_left(starts, s0)
        if k < len(starts) and starts[k] < s1:
            leads.append(starts[k] - s0)
    if not leads or len(leads) < len(trace.series):
        return None
    return sum(leads) / len(leads) / 1e3
