"""toeplitz_psf_ms: the mean duration of the port's `tron.toeplitz_psf` span
over the profiled series: one build of a frame's Toeplitz multiplier
(`solver.toeplitz_fourier_kernel`: the Ram-Lak weights gridded at the
doubled geometry, the adjoint's epilogue at twice the image size and an
``fft2``, then on the card its copy into the graphed solve's static
multiplier), as the host enqueues it, in ms.  None where no such span was
recorded.  Layer: the CGNR solver, `solver.cgnr_radial2d` (its multiplier,
`solver.toeplitz_fourier_kernel`)."""

from benchmark.spans import durations


def read(trace):
    builds = [d for per in durations(trace, "tron.toeplitz_psf") for d in per]
    return sum(builds) / len(builds) / 1e3 if builds else None
