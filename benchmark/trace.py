"""The traced run's reduction: one torch.profiler session over whole series,
taken apart into the harness's spans around each series, the device's
kernels and copies, and the host's launch calls, for the per-layer
metrics' readers (`metrics/<name>.py`, each ``read(trace) -> float |
None``) and for the result's ``busy_s``, ``window_s`` and ``breakdown``.
Times are the profiler's, in microseconds.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

SERIES_SPAN = "benchmark.series"
# the CUDA runtime and driver calls that launch work on the device, one each
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def is_copy(name: str) -> bool:
    """A device copy or fill, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Trace:
    series: list          # (start, end) of each profiled series' span
    device: list          # (start, end, name) of each kernel, copy and fill
    host: list            # (start, end, name) of each host op but the spans
    launches: int         # launch calls on the host
    geometry: dict        # the series' shapes (traffic.geometry)

    @property
    def frames(self) -> int:
        return len(self.series) * self.geometry["nz"]

    @property
    def window(self) -> tuple[float, float]:
        return self.series[0][0], self.series[-1][1]

    def kernels(self) -> list:
        return [d for d in self.device if not is_copy(d[2])]

    def kernel_us(self, names: tuple) -> tuple[float, int]:
        """Device time and count of the kernels whose name holds one of
        ``names``."""
        hits = [e - s for s, e, n in self.device if any(k in n for k in names)]
        return sum(hits), len(hits)

    def busy(self) -> list:
        """The union of device intervals inside the window, merged."""
        w0, w1 = self.window
        merged = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def gaps(self) -> list:
        """(start, end) of each stretch of the window with nothing on the device."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy() for x in iv] + [w1]
        return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]

    def host_op_at(self, t: float) -> str:
        """The innermost host op open at ``t``: of those that hold it, the
        last to start (the series' span if none does)."""
        starts = np.array([h[0] for h in self.host])
        ends = np.array([h[1] for h in self.host])
        open_ = np.flatnonzero((starts <= t) & (ends > t))
        if open_.size == 0:
            return SERIES_SPAN
        return self.host[open_[np.argmax(starts[open_])]][2]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, each under the host op open when it began;
        seconds each."""
        ops = collections.Counter()
        for s, e, n in self.device:
            ops[n] += (e - s) / 1e6
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
                "idle_gaps": [[self.host_op_at(s), (e - s) / 1e6] for s, e in longest]}


def profile(run_series, n: int) -> list:
    """``run_series(i)`` for i < n under the profiler, each inside the
    harness's span; returns the profiler's raw events (not turned into
    Python event objects, which takes minutes for a long trace)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            with torch.profiler.record_function(SERIES_SPAN):
                run_series(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return prof.profiler.kineto_results.events()


def reduce(events, geometry: dict) -> Trace:
    """The profiler's raw events -> a Trace, times in microseconds from the
    first event.  A host range that the trace mirrors on the device (the
    harness's span, the port's named ranges) is no device work and is left
    out of it."""
    cuda = torch.autograd.DeviceType.CUDA
    t0 = min((ev.start_ns() for ev in events), default=0)
    ranges = {ev.name() for ev in events if ev.is_user_annotation()}
    series, device, host, launches = [], [], [], 0
    for ev in events:
        name, s = ev.name(), (ev.start_ns() - t0) / 1e3
        e = s + ev.duration_ns() / 1e3
        if ev.device_type() == cuda:
            if name not in ranges:
                device.append((s, e, name))
        elif name == SERIES_SPAN:
            series.append((s, e))
        else:
            host.append((s, e, name))
            launches += name in LAUNCH_CALLS
    series.sort()
    return Trace(series, device, host, launches, geometry)
