"""The one generator of the benchmark's traffic: what a cell's series looks
like and how much of it is traced and checked, from the configuration's
file and the traffic mix's file (`traffic/<name>.json`):

- ``recon``: the mix's changes to the configuration's recon settings;
  ``"adjoint": false`` makes the series a forward one;
- ``reference``: the plain reference it is compared with,
  `reference/<name>.py` ("recon" where the mix names none);
- ``traced_msamples``: a traced run profiles whole series until they hold
  at least this many million coil-samples (at least one series);
- ``check_frames``: the frames of each series kept for the comparison with
  the reference, drawn from the seed; one series, drawn from the seed among
  the first three, is kept whole.

Every series of a run takes the same input, drawn on the device from
``--seed`` in one call and copied once into host memory that numpy
allocated, as the `.ra` reader's is.  An adjoint series takes complex64
samples in `.ra` dims (nc, 1, nro, npe1); a forward one takes nz frames of
complex64 coil images in `.ra` dims (nc, 1, nx, ny, nz), laid out as
`ra_read` returns them: Fortran order, the C array of the reversed dims
viewed transposed.  The seed changes the data, never the shapes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.recon import frame_geometry
from benchmark.spec import Cell


def geometry(cell: Cell) -> dict:
    """The series' shapes from the configuration's file.  An adjoint series
    grids nz sliding-window frames of ``work`` spokes out of the npe1 the
    configuration states.  A forward one synthesises each of the nz frames
    of nx x nx coil images that its configuration states (``nx``, ``nz``)
    into int(u nro) spokes of nro = gridos nx readouts, as TRON's forward
    sizes its output, on the one angle set that starts at ``skip_angles``
    (so ``slide`` 0)."""
    c, r = cell.config, cell.recon
    if r["adjoint"]:
        work, slide, nz = frame_geometry(r, c["nro"], c["npe1"])
        n, nro, npe1 = c["nro"] // 2, c["nro"], c["npe1"]
    else:
        if "nx" not in c or "nz" not in c:
            raise ValueError(f"configuration {c.get('name')} states no image size nx and "
                             f"frame count nz for a forward series")
        n, nz, slide = int(c["nx"]), int(c["nz"]), 0
        nro = int(n * r["gridos"])
        work = npe1 = int(nro * r["data_undersamp"])
    return {"adjoint": bool(r["adjoint"]), "nc": c["nc"], "nro": nro, "npe1": npe1,
            "work": work, "slide": slide, "nz": nz, "n": n, "nxos": int(n * r["gridos"]),
            "kernwidth": float(r["kernwidth"]), "skip": int(r["skip_angles"]),
            "niter": int(r.get("niter", 0))}


def series_samples(geo: dict) -> int:
    """Coil-samples a series grids or synthesises: nz nc nro work."""
    return geo["nz"] * geo["nc"] * geo["nro"] * geo["work"]


def traced_series(cell: Cell, geo: dict) -> int:
    """Whole series a traced run profiles."""
    return max(1, math.ceil(cell.traffic["traced_msamples"] * 1e6 / series_samples(geo)))


def make_input(geo: dict, seed: int, device: torch.device) -> np.ndarray:
    """The series' input from ``seed``, made on ``device`` in one call and
    copied into an array that numpy allocated, as the `.ra` reader's is
    (numpy asks the kernel for huge pages for large arrays): the samples of
    an adjoint series, or the images of a forward one, complex Gaussian."""
    g = torch.Generator(device=device).manual_seed(seed % 2**64)
    if geo["adjoint"]:
        shape = (geo["nc"], 1, geo["nro"], geo["npe1"])
    else:
        # the reversed `.ra` dims, C order: viewed transposed below
        shape = (geo["nz"], geo["n"], geo["n"], 1, geo["nc"])
    x = torch.randn(shape, generator=g, device=device, dtype=torch.complex64)
    host = np.empty(shape, np.complex64)
    torch.from_numpy(host).copy_(x)
    return host if geo["adjoint"] else host.T


class CheckPlan:
    """Which frames of which series the comparison keeps, from the seed."""

    def __init__(self, cell: Cell, geo: dict, seed: int):
        self.nz = geo["nz"]
        self.per_series = min(int(cell.traffic["check_frames"]), self.nz)
        self.seed = seed % 2**64
        self.whole = int(np.random.default_rng([self.seed, 0]).integers(0, 3))

    def frames(self, i: int) -> np.ndarray:
        """Frame indices kept of series ``i``: every frame of the series
        drawn to be kept whole (the harness keeps the last one whole where
        fewer ran)."""
        if i == self.whole:
            return np.arange(self.nz)
        rng = np.random.default_rng([self.seed, 1, i])
        return np.sort(rng.choice(self.nz, self.per_series, replace=False))
