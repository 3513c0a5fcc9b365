"""frame_host_ms: the time in the port's `tron.frame` spans over the
profiled series (one span per frame of a frame loop, its write into the
output included: `recon._map_frames`, `recon.incremental_scan`), per frame
of the geometry, in ms.  Per frame of the geometry, not per span: a
scheduler that takes several frames in one step reads right.  Layer: the
frame scheduler, `recon.recon_frames`."""

from benchmark.spans import durations


def read(trace):
    total = sum(map(sum, durations(trace, "tron.frame")))
    if total == 0 or not trace.frames:
        return None
    return total / trace.frames / 1e3
