"""Device selection (counterpart of the CLI's `-g` handling in
`tron_tpu/cli.py`, which picks a JAX device index).

The port never substitutes the CPU for a missing card: a run that asks for
a GPU either gets one or fails here.
"""

from __future__ import annotations

import torch


def resolve_device(index: int = 0) -> torch.device:
    """The CUDA device ``cuda:index``; raises if CUDA is missing or the
    index is out of range."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA device {index} requested but torch {torch.__version__} "
            "sees no CUDA device"
        )
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise RuntimeError(
            f"CUDA device index {index} out of range: {count} device(s) visible"
        )
    return torch.device("cuda", index)
