"""d2h_ms: per profiled series, the time in the port's `tron.readback`
span, the images' copy to pageable host memory with the drain of the
card's queue before it (`recon._fetch_host`); the mean over the profiled
series, in ms.  Layer: the host driver, `recon.recon_radial2d`."""

from benchmark.spans import per_series_ms


def read(trace):
    return per_series_ms(trace, "tron.readback")
