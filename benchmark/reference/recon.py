"""The reference's sliding-window series: the frames a recon of a host
input in `.ra` dims (nc, 1, nro, npe1) gives, adjoint, worked out
from the configuration's file alone (`benchmark/configs/*.json`, with the
traffic mix's changes), in blocks of frames so that it fits on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nufft


def frame_geometry(recon: dict, nro: int, npe1: int) -> tuple[int, int, int]:
    """(spokes per frame, spokes between frames, frames) of a series
    (`src/tron.cu:916-928`)."""
    cap = int(nro * recon["data_undersamp"])
    work = npe1 if npe1 <= cap else cap
    slide = recon["prof_slide"] if recon["prof_slide"] > 0 else work
    return work, slide, 1 + (npe1 - work) // slide


def _radius_rows(nxos: int, nro: int):
    """The grid radii the gridder fills, -nxos/2+1 .. nxos/2-1, and the
    readout each takes its sample from: trunc(r nro / nxos) + nro/2
    (`src/tron.cu:501, 517`)."""
    rr = torch.arange(nxos, dtype=torch.float64) - nxos // 2
    ridx = torch.trunc(rr * (nro / nxos)).long() + nro // 2
    keep = (rr > -(nxos // 2)) & (ridx >= 0) & (ridx < nro)
    return rr[keep], ridx[keep]


# the recon settings the reference works out, each with the values it takes
# (None: any)
SETTINGS = {"adjoint": (True,), "golden_angle": (True,), "data_undersamp": None,
            "prof_slide": None, "gridos": None, "kernwidth": None, "skip_angles": None,
            "niter": (0,)}


class Series:
    """One series' input on ``device`` and its frames' geometry."""

    def __init__(self, indata: np.ndarray, recon: dict, device):
        for k, v in recon.items():
            if k not in SETTINGS or (SETTINGS[k] is not None and v not in SETTINGS[k]):
                raise ValueError(f"the reference does not work out the recon setting {k}={v!r}")
        nc, _, nro, npe1 = indata.shape
        self.recon, self.device = recon, torch.device(device)
        self.nc, self.nro = nc, nro
        self.kw = float(recon["kernwidth"])
        self.n = nro // 2
        self.nxos = int(self.n * recon["gridos"])
        self.work, self.slide, self.nz = frame_geometry(recon, nro, npe1)
        # (nc, npe1, nro): spokes on the second axis
        self.data = torch.from_numpy(indata[:, 0]).to(self.device).transpose(1, 2)

    def window(self, frames: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """The frames' samples (F, C, work, nro) and angles (F, work)."""
        d = torch.stack([self.data[:, z * self.slide:z * self.slide + self.work]
                         for z in frames])
        a = torch.stack([nufft.golden_angles(self.work, self.recon["skip_angles"]
                                             + z * self.slide) for z in frames])
        return d, a.to(self.device)

    def adjoint(self, d: torch.Tensor, a: torch.Tensor, quant: str) -> torch.Tensor:
        """Density-compensated gridding, scaled 1/(nxos work), then the
        image of each coil's grid."""
        rr, ridx = _radius_rows(self.nxos, self.nro)
        w = nufft.ramlak(self.nro, self.work).to(self.device)
        s = (d * w)[..., ridx.to(self.device)]
        kg = nufft.grid(s, rr, a, self.nxos, self.kw, quant) * (1.0 / (self.nxos * self.work))
        return nufft.image_of_grid(kg, self.n, self.kw)

    def frames(self, frames: list[int], quant: str = "float32", block: int = 32
               ) -> torch.Tensor:
        """The combined images (F, n, n) complex64 of ``frames``, ``block``
        frames at a time."""
        out = []
        for i in range(0, len(frames), block):
            d, a = self.window(frames[i:i + block])
            out.append(nufft.sos(self.adjoint(d, a, quant)))
        return torch.cat(out)
