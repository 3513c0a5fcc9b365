"""h2d_ms: per profiled series, the time in the port's `tron.upload` span,
the copy of the relaid input from pageable host memory to the card
(`recon.recon_radial2d`); the mean over the profiled series, in ms.
Layer: the host driver, `recon.recon_radial2d`."""

from benchmark.spans import per_series_ms


def read(trace):
    return per_series_ms(trace, "tron.upload")
