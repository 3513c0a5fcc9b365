"""Recon over several devices, one process each, on `torch.distributed`
(counterpart of `tron_tpu/parallel/`): frames x coils over a process mesh
(`mesh.py`), one frame's spokes over a 'spoke' axis (`spoke.py`), the mesh
and its collectives (`distributed.py`) and a starter of ranks on one host
(`launch.py`).

The names are those of `tron_tpu.parallel`.  They resolve on first use: the
solver and the frame schedulers import `distributed` for their collectives,
and `mesh` and `spoke` import them back.
"""

import importlib

_HOME = {
    "make_mesh": "mesh",
    "recon_forward_sharded": "mesh",
    "recon_frames_sharded": "mesh",
    "recon_stack_of_stars_sharded": "mesh",
    "make_spoke_mesh": "spoke",
    "nufft_adjoint_spoke_sharded": "spoke",
    "recon_window_spoke_sharded": "spoke",
}

__all__ = [
    "make_mesh",
    "recon_forward_sharded",
    "recon_frames_sharded",
    "recon_stack_of_stars_sharded",
    "distributed",
    "make_spoke_mesh",
    "nufft_adjoint_spoke_sharded",
    "recon_window_spoke_sharded",
]


def __getattr__(name):
    if name in ("distributed", "launch", "mesh", "spoke"):
        return importlib.import_module(f"{__name__}.{name}")
    if name in _HOME:
        return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
