"""Named spans of the port's work in a torch.profiler session.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records (``tron-torch --profile DIR``, a benchmark's traced run),
so the host's work shows in the trace on the same clock as the device's
kernels and copies; otherwise it is one shared null context, and the
recon pays a module attribute's check for it.  ``SPANS`` names every span
the port records:

- ``tron.relayout``: `recon.recon_radial2d`'s host transpose of the input
  into the ops layout, and its wrap as a tensor;
- ``tron.upload``: that tensor's copy to the device;
- ``tron.prep``: the once-per-series sample prep of a frame scheduler
  (density compensation, the sample planes);
- ``tron.frame``: one frame of a frame loop, its write into the output
  included;
- ``tron.readback``: the images' copy to the host, the queue's drain
  included;
- ``tron.<kernel>`` for each gridding kernel (`ops/grid_cuda.KERNELS`):
  one gridding wrapper call, routed to that kernel or, on the CPU, to its
  plain version;
- ``tron.degrid_radial2d``: the degridding kernel's launch.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

SPANS = (
    "tron.relayout",
    "tron.upload",
    "tron.prep",
    "tron.frame",
    "tron.readback",
    "tron.grid_radial2d",
    "tron.grid_radial2d_batched",
    "tron.grid_seg_radial2d",
    "tron.degrid_radial2d",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that names its work ``name`` (one of ``SPANS``) in a
    recording profiler's trace, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
