"""Named spans of the port's work in a torch.profiler session.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records (``tron-torch --profile DIR``, a benchmark's traced run),
so the host's work shows in the trace on the same clock as the device's
kernels and copies; otherwise it is one shared null context, and the
recon pays a module attribute's check for it.  ``SPANS`` names every span
the port records:

- ``tron.upload``: `recon.recon_radial2d`'s copy of the input to the
  device in the memory order the host array has (after one host copy
  where it is neither C- nor Fortran-contiguous complex64);
- ``tron.relayout``: the permute of that copy into the ops layout, on the
  device;
- ``tron.prep``: the once-per-series sample prep of a frame scheduler
  (density compensation, the sample planes);
- ``tron.frame``: one frame of a frame loop, its write into the output
  included;
- ``tron.angles``: one call's spoke angles built on the device by
  `trajectory.spoke_angles`, the host's waits on its scalar uploads
  included: a frame's in `recon.reconstruct_frame` (the CGNR frame,
  inside its ``tron.frame`` and before its ``tron.cgnr``), a forward's
  one set in `recon._forward_radial2d` and `_koosh_forward_device`.  The
  hoisted schedulers read rows of a table built inside ``tron.prep`` and
  open none;
- ``tron.combine``: one coil combine run eagerly by
  `recon.reconstruct_frame`, inside its ``tron.frame`` and after its
  ``tron.cgnr``; a combine inside a captured chain adds nothing at
  replay and records none.  What is left of such a frame outside these
  two spans and its ``tron.cgnr`` is the write into the output and, in
  a graphed solve, its cache key and the angles' copy into its graph;
- ``tron.frame_graph``: the capture of one frame's device chain as a CUDA
  graph (`recon.recon_frames`, once per geometry);
- ``tron.incremental_step``: one telescoped frame's delta
  (`recon.incremental_scan`), inside that frame's ``tron.frame``; a
  scan's first frame, gridded whole, opens none.  Run eagerly (the CPU,
  and a scan's second frame on the card): the leaving (negated) and
  entering spokes' planes and their row of the angle table, their
  gridding and the scaled add into the carried grid, with the epilogue,
  combine and write after it, outside the step.  Replayed (every later
  frame on the card): the copies of those spokes and their angles into
  the graph's static inputs and the graph's launch, which runs the
  epilogue and combine too; the write follows outside the step;
- ``tron.incremental_graph``: the capture of the telescoped frame's
  device chain as a CUDA graph (`recon.incremental_scan`, once per
  geometry);
- ``tron.readback``: the images' way back to the host after the last
  frame, on the calling thread.  On the card an in-memory adjoint's
  blocks are copied while the frame loops run (`recon._BlockReadback`),
  so it spans the wait for the blocks still in flight, the queue's drain
  included; on the CPU and with ``half_readback`` the images are copied
  whole inside it, the queue's drain included;
- ``tron.cgnr``: one frame's CGNR solve (`solver.cgnr_radial2d`), inside
  its ``tron.frame``; ``tron.toeplitz_psf``: one build of a solve's
  Toeplitz multiplier (`solver.toeplitz_fourier_kernel`: the weights
  gridded at the doubled geometry, the epilogue and the FFT), inside its
  ``tron.cgnr``, before the right side; ``tron.cgnr_rhs``: its right side
  A^H W d and the state CG starts from; in a graphed solve (on the card)
  after a geometry's first, each of these two is one replay's enqueue on
  the card; ``tron.cgnr_iter``: one iteration: in the eager loop its stop
  test's read of the residual on the host and its step, in a graphed
  solve one replay of the captured step (a geometry's first iteration:
  the step run eagerly before the capture), ``niter`` of them a solve
  whatever the stop test finds; ``tron.cgnr_graph``: the captures of a
  geometry's CG step, multiplier and right side as CUDA graphs (once per
  geometry, inside that solve's ``tron.cgnr``);
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
    "tron.angles",
    "tron.combine",
    "tron.frame_graph",
    "tron.incremental_step",
    "tron.incremental_graph",
    "tron.readback",
    "tron.cgnr",
    "tron.cgnr_rhs",
    "tron.cgnr_iter",
    "tron.cgnr_graph",
    "tron.toeplitz_psf",
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
