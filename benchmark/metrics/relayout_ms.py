"""relayout_ms: per profiled series, the time in the port's
`tron.relayout` span, the host transpose of the input into the ops layout
and its wrap as a tensor (`recon.recon_radial2d`), which the card waits
for; the mean over the profiled series, in ms.  Layer: the host driver,
`recon.recon_radial2d`."""

from benchmark.spans import per_series_ms


def read(trace):
    return per_series_ms(trace, "tron.relayout")
