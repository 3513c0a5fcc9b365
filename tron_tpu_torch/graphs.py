"""The port's CUDA graphs: one capture, one cache, one take-back of the
host's counters.  Its users are the direct frame scheduler
(`recon.recon_frames`), the telescoping one (`recon.incremental_scan`:
a frame's step, epilogue and combine, with the carried grid a static
tensor that no replay copies into) and the CGNR solve
(`solver.cgnr_radial2d`: its multiplier, its right side and its
iteration).

A capture launches nothing on the card, so what it adds to the launch
counters (`ops/grid_cuda.LAUNCH_COUNTS`, `ops/degrid_cuda.LAUNCHES`), and
to any count a user hands over, is taken back, and added again at each
replay: the counters count what reached the card.  Besides the two kernel
wrappers, only this module writes the launch counters.
"""

from __future__ import annotations

import collections

import torch

from tron_tpu_torch.ops import degrid_cuda, grid_cuda

# entries kept a user, most recently used last; each holds its geometry's
# intermediates (~50 MB a whole-body frame: B1's workspace, grid, FFT)
KEPT = 4


def _launches() -> dict:
    return {**grid_cuda.LAUNCH_COUNTS, "degrid_radial2d": degrid_cuda.LAUNCHES}


def _add_launches(n: dict) -> None:
    for k in grid_cuda.KERNELS:
        grid_cuda.LAUNCH_COUNTS[k] += n[k]
    degrid_cuda.LAUNCHES += n["degrid_radial2d"]


def _capture(fn, static: tuple):
    """(graph, static output) of ``fn(*static)``, captured on a side stream
    of the inputs' device and thread-local, so other threads (the streamed
    recon's loader and reader) copy on their own streams meanwhile."""
    graph = torch.cuda.CUDAGraph()
    device = static[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.Stream(device)
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            out = fn(*static)
    return graph, out


def _add(counts: dict, n: dict, sign: int = 1) -> None:
    for k, v in n.items():
        counts[k] += sign * v


class Chain:
    """``fn(*static)`` captured once on the ``static`` tensors handed over;
    a failed capture raises.  ``replay(*inputs)`` copies each input into its
    static tensor (the first ``len(inputs)``; the rest are the chain's own
    state), replays on the current stream and returns the static output,
    which the next replay overwrites.  ``counts``: the user's own
    dicts of host counts that ``fn`` adds to; what the capture added to
    them is taken back and added again at each replay, as for the launch
    counters."""

    def __init__(self, fn, *static: torch.Tensor, counts: tuple[dict, ...] = ()):
        self.static = static
        before, counted = _launches(), [dict(c) for c in counts]
        try:
            self.graph, self.out = _capture(fn, static)
        finally:
            self.launches = {k: n - before[k] for k, n in _launches().items()}
            _add_launches({k: -n for k, n in self.launches.items()})
            self.counts = [(c, {k: n - b[k] for k, n in c.items()})
                           for c, b in zip(counts, counted)]
            for c, n in self.counts:
                _add(c, n, -1)

    def replay(self, *inputs: torch.Tensor):
        for s, x in zip(self.static, inputs):
            s.copy_(x)
        self.graph.replay()
        _add_launches(self.launches)
        for c, n in self.counts:
            _add(c, n)
        return self.out


class Cache:
    """One user's entries by its key, and its ``counts`` of graphs
    captured, of frames or solves replayed and of those run eagerly."""

    def __init__(self):
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.counts = {"captured": 0, "replayed": 0, "eager": 0}

    def get(self, key, make):
        """The entry of ``key`` (``make()`` on a miss), now the most recent;
        the least recent beyond ``KEPT`` is dropped."""
        entry = self.entries.pop(key, None)
        if entry is None:
            entry = make()
        self.entries[key] = entry
        while len(self.entries) > KEPT:
            self.entries.popitem(last=False)
        return entry

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0
