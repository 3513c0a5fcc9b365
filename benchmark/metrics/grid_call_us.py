"""grid_call_us: the mean duration of the port's `tron.grid_radial2d`
span over the profiled series: one call of the default gridding kernel's
wrapper (`ops/grid_cuda.grid_radial2d_planes`: class, checks, cos and sin,
output and workspace, the launch, its error check), in us.  Layer: the
gridding wrapper, `ops/grid_cuda`."""

from benchmark.spans import durations


def read(trace):
    calls = [d for per in durations(trace, "tron.grid_radial2d") for d in per]
    return sum(calls) / len(calls) if calls else None
