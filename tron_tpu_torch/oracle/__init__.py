from tron_tpu_torch.oracle.dtft import (
    dtft2,
    dtft2_adjoint,
    dtft2_adjoint_chunked,
    oracle_adjoint_recon,
)

__all__ = [
    "dtft2",
    "dtft2_adjoint",
    "dtft2_adjoint_chunked",
    "oracle_adjoint_recon",
]
