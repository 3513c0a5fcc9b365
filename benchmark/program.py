"""The program under test as the benchmark drives it: the port's host-to-host
recon entry, `tron_tpu_torch.recon.recon_radial2d`, and its gridding
kernel's launch counter.  The only module of the benchmark that imports the port.
"""

from __future__ import annotations

import numpy as np
import torch


class Program:
    """The port loaded for one cell on ``device``: its configuration, the
    one timed call and the counter the trace is checked against."""

    def __init__(self, recon: dict, precision: str, device: torch.device):
        from tron_tpu_torch import recon as port_recon
        from tron_tpu_torch.config import ReconConfig
        from tron_tpu_torch.ops import grid_cuda

        self._recon, self._grid = port_recon, grid_cuda
        self.cfg = ReconConfig(**recon, matmul_dtype=precision)
        self.device = device
        if device.type == "cuda":
            # the kernels' library: built by nvcc on a checkout's first run
            # (build/tron_tpu_torch/, keyed by the sources), loaded after
            from tron_tpu_torch import _build

            _build.load()

    def series(self, indata: np.ndarray) -> np.ndarray:
        """One series host to host: samples in `.ra` dims (nc, 1, nro, npe1)
        -> combined images (nz, n, n) complex64 in host memory."""
        return self._recon.recon_radial2d(indata, self.cfg, device=self.device)[:, 0]

    def counters(self) -> dict:
        """Launches so far of the default gridding kernel (B1): one per
        wrapper call that reached the card."""
        return {"grid": self._grid.LAUNCH_COUNTS["grid_radial2d"]}
