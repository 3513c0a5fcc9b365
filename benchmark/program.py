"""The program under test as the benchmark drives it: the port's host-to-host
recon entry, `tron_tpu_torch.recon.recon_radial2d`, in either direction,
and its kernels' launch counters.  The only module of the benchmark that
imports the port.
"""

from __future__ import annotations

import numpy as np
import torch


class Program:
    """The port loaded for one cell on ``device``: its configuration, the
    one timed call and the counters the trace is checked against."""

    def __init__(self, recon: dict, precision: str, device: torch.device):
        from tron_tpu_torch import recon as port_recon
        from tron_tpu_torch.config import ReconConfig
        from tron_tpu_torch.ops import degrid_cuda, grid_cuda

        self._recon, self._grid, self._degrid = port_recon, grid_cuda, degrid_cuda
        self.cfg = ReconConfig(**recon, matmul_dtype=precision)
        self.device = device
        if device.type == "cuda":
            # the kernels' library: built by nvcc on a checkout's first run
            # (build/tron_tpu_torch/, keyed by the sources), loaded after
            from tron_tpu_torch import _build

            _build.load()

    def series(self, indata: np.ndarray) -> np.ndarray:
        """One series host to host, one array per frame on the first axis:
        adjoint, samples in `.ra` dims (nc, 1, nro, npe1) -> combined images
        (nz, n, n); forward, images in `.ra` dims (nc, 1, nx, ny, nz) ->
        samples (nz, nc, npe1, nro); complex64 in host memory."""
        out = self._recon.recon_radial2d(indata, self.cfg, device=self.device)
        return out[:, 0] if self.cfg.adjoint else out[:, :, 0]

    def counters(self) -> dict:
        """Launches so far of each kernel the benchmark checks the trace
        against, by a part of its name as the profiler records it: the
        default gridding kernel (B1) one contraction per wrapper call that
        reached the card, the degridding kernel (B3) one per launch."""
        return {"grid_tile_contract_kernel": self._grid.LAUNCH_COUNTS["grid_radial2d"],
                "degrid_radial2d_kernel": self._degrid.LAUNCHES}
