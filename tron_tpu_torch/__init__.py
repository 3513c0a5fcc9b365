"""tron_tpu_torch: the PyTorch/CUDA port of tron_tpu (the JAX/TPU package
beside it, which stays the reference).

The golden-angle sliding-window adjoint recon (in memory or streamed from
disk), the forward operator, the CGNR solver, the 3-D stack-of-stars recon
(`-3`), the Walsh combine, coil compression and the recon over several
devices (`parallel/`, one process per device) run here, with adjoint
gridding and forward degridding in hand-written CUDA kernels (`csrc/`: the
tile gridder, its tensor-core variant, the segmented gridder and the
degridder) and the rest in plain torch.  Module names follow tron_tpu's, so each
module's counterpart is the file of the same name there.  This package
imports torch and never JAX.
"""

from tron_tpu_torch.config import AngleScheme, ReconConfig
from tron_tpu_torch.nufft import nufft_adjoint, nufft_forward
from tron_tpu_torch.recon import recon_radial2d
from tron_tpu_torch.solver import cgnr_radial2d

__all__ = [
    "AngleScheme",
    "ReconConfig",
    "cgnr_radial2d",
    "nufft_adjoint",
    "nufft_forward",
    "recon_radial2d",
]
