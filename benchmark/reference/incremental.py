"""The plain reference of TRON's sliding-window series reconstructed by the
telescoping scheduler (`tron -a -G --incremental`): the same frames as the
direct series, each gridded from scratch.

The scheduler grids a series' first window whole and advances every later
frame by one signed gridding call of the spokes that leave and enter it,
which is exact because gridding is linear over spokes and a golden-angle
spoke's angle depends only on its global index (`src/tron.cu:509`).  So
its frames are, by definition, those of the direct series: each frame's own
``work`` spokes density-compensated, KB-gridded, scaled 1/(nxos work),
through the epilogue and the coils' root sum of squares.  This reference
computes each frame that way, `recon.py`'s ``Series`` over that frame's
window alone, and never carries a grid from one frame to the next: drift
in the program's carried grid shows as error in its later frames.

Everything in float32 with the KB and deapodisation weights and the sample
positions in float64, TF32 off; ``quant`` rounds the gridding operands as
in `recon.py`.
"""

from __future__ import annotations

import torch

from benchmark.reference import recon

# the recon settings the reference works out, each with the values it takes
# (None: any)
SETTINGS = {**recon.SETTINGS, "incremental": (True,)}


class Series(recon.Series):
    """One series' input on ``device`` and its frames' geometry."""

    def __init__(self, indata, recon_settings: dict, device):
        for k, v in recon_settings.items():
            if k not in SETTINGS or (SETTINGS[k] is not None and v not in SETTINGS[k]):
                raise ValueError(f"the reference does not work out the recon setting {k}={v!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(indata, {k: v for k, v in recon_settings.items()
                                  if k != "incremental"}, device)
