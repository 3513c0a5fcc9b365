"""The one generator of the benchmark's traffic: what a cell's series looks
like and how much of it is traced and checked, from the configuration's
file and the traffic mix's file (`traffic/<name>.json`):

- ``recon``: the mix's changes to the configuration's recon settings;
- ``traced_msamples``: a traced run profiles whole series until they hold
  at least this many million coil-samples (at least one series);
- ``check_frames``: the frames of each series kept for the comparison with
  the reference, drawn from the seed; one series, drawn from the seed among
  the first three, is kept whole.

Every series of a run takes the same input: complex64 samples in `.ra`
dims (nc, 1, nro, npe1), drawn on the device from ``--seed`` and copied
once to host memory.  The seed changes the data, never the shapes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.recon import frame_geometry
from benchmark.spec import Cell


def geometry(cell: Cell) -> dict:
    """The series' shapes from the configuration's file."""
    c = cell.config
    work, slide, nz = frame_geometry(cell.recon, c["nro"], c["npe1"])
    n = c["nro"] // 2
    return {"nc": c["nc"], "nro": c["nro"], "npe1": c["npe1"], "work": work, "slide": slide,
            "nz": nz, "n": n, "nxos": int(n * cell.recon["gridos"]),
            "kernwidth": float(cell.recon["kernwidth"]),
            "skip": int(cell.recon["skip_angles"]), "niter": int(cell.recon["niter"])}


def series_samples(geo: dict) -> int:
    """Coil-samples a series grids: nz nc nro work."""
    return geo["nz"] * geo["nc"] * geo["nro"] * geo["work"]


def traced_series(cell: Cell, geo: dict) -> int:
    """Whole series a traced run profiles."""
    return max(1, math.ceil(cell.traffic["traced_msamples"] * 1e6 / series_samples(geo)))


def make_input(geo: dict, seed: int, device: torch.device) -> np.ndarray:
    """The series' samples from ``seed``, made on ``device`` in one call
    and copied into an array that numpy allocated, as the `.ra` reader's
    are (numpy asks the kernel for huge pages for large arrays)."""
    g = torch.Generator(device=device).manual_seed(seed % 2**64)
    shape = (geo["nc"], 1, geo["nro"], geo["npe1"])
    x = torch.randn(shape, generator=g, device=device, dtype=torch.complex64)
    host = np.empty(shape, np.complex64)
    torch.from_numpy(host).copy_(x)
    return host


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
