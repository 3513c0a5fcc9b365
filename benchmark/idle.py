"""The CGNR frame taken apart by the port's own spans, for the readers of
its scheduler half (`metrics/cgnr_sched_*.py`) and of the card's idle
time in it (`metrics/cgnr_solve_idle_pct.py`).

A CGNR frame is one ``tron.frame`` span that holds one ``tron.cgnr`` (the
solve); the frame's scheduler half is the rest of it: ``tron.angles``,
``tron.combine``, the write into the output and the solver's cache key
(`host_split`).  Each stretch of the window with nothing on the card
(`trace.Trace.gaps`) is put down to the innermost ``tron.*`` span open on
the host when it began, of those that hold that instant the last to
start, and sorted into one of ``CLASSES``: ``solve`` where that span is a
``tron.cgnr`` or lies inside one, ``scheduler`` where it lies inside a
``tron.frame`` (or is one) but not inside a ``tron.cgnr``, ``other``
where it is any other span (the upload, the relayout, the readback),
where no span is open, or where the profiler's own host work
(``PROFILER_OPS``) is open when the gap begins: the card waits on the
profiler there, not on the port.  Times are the profiler's, in
microseconds.

    python -m benchmark.idle --workload W --seed N

profiles a cell's series as a traced run does (one series first, then a
profile in a process of its own) and prints the idle split, the scheduler
half's host time by span and the four readers as one JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json

FRAME, SOLVE = "tron.frame", "tron.cgnr"
CLASSES = ("solve", "scheduler", "other")
# the profiler's buffer handling, recorded among the host's ops
PROFILER_OPS = ("Activity Buffer Request", "Buffer Flush")
READERS = ("cgnr_sched_host_ms", "cgnr_sched_launches_per_frame", "cgnr_sched_idle_pct",
           "cgnr_solve_idle_pct")


def port_spans(trace, name: str | None = None) -> list:
    """(start, end, name) of the port's spans (``name`` alone, else every
    ``tron.*``) that start inside a profiled series, by start, an outer
    span before an inner one that starts with it."""
    series = trace.series
    return sorted((h for h in trace.host
                   if (h[2] == name if name else h[2].startswith("tron."))
                   and any(s0 <= h[0] < s1 for s0, s1 in series)),
                  key=lambda h: (h[0], -h[1]))


class Holder:
    """Spans of one name, which never overlap one another: which of them
    holds an instant or an interval."""

    def __init__(self, spans: list):
        self.spans = sorted((s, e) for s, e, *_ in spans)
        self.starts = [s for s, _ in self.spans]

    def holding(self, s: float, e: float | None = None):
        """The span that holds [s, e] (the instant s, without e), or None."""
        k = bisect.bisect_right(self.starts, s) - 1
        if k < 0:
            return None
        s0, e0 = self.spans[k]
        return self.spans[k] if (e0 > s if e is None else e0 >= e) else None


def sched_frames(trace):
    """The frames' and their solves' spans, ``(frames, solves)``, each solve
    one that a frame holds; None unless the series hold both."""
    frames, solves = port_spans(trace, FRAME), port_spans(trace, SOLVE)
    held = Holder(frames)
    solves = [c for c in solves if held.holding(c[0], c[1])]
    if not frames or not solves:
        return None
    return frames, solves


def host_split(trace):
    """The scheduler half's host time a frame of the geometry, in ms, by
    span: the ``tron.angles`` and ``tron.combine`` that CGNR frames hold,
    and the ``rest`` (the write, the cache key); they sum to
    `metrics/cgnr_sched_host_ms.py`'s.  None where no frame holds a solve."""
    got = sched_frames(trace)
    if got is None or not trace.frames:
        return None
    frames, solves = got
    held = Holder(frames)

    def ms(spans):
        return sum(e - s for s, e, *_ in spans) / trace.frames / 1e3

    out = {k: ms([h for h in port_spans(trace, f"tron.{k}") if held.holding(h[0], h[1])])
           for k in ("angles", "combine")}
    out["rest"] = ms(frames) - ms(solves) - out["angles"] - out["combine"]
    return out


def innermost(trace) -> list:
    """(start, end, span) of each idle gap, ``span`` the innermost port
    span (start, end, name) open on the host when the gap began, or None.
    One sweep over the gaps and the spans, both by start: a stack of the
    spans begun so far, the ended popped from its top."""
    spans, out, stack, k = port_spans(trace), [], [], 0
    for g0, g1 in trace.gaps():
        while k < len(spans) and spans[k][0] <= g0:
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        out.append((g0, g1, stack[-1] if stack else None))
    return out


def profiler_open(trace):
    """Whether one of ``PROFILER_OPS`` is open on the host at an instant:
    the ops by start, each with the latest end of those begun so far."""
    ops = sorted((s, e) for s, e, n in trace.host if n in PROFILER_OPS)
    starts = [s for s, _ in ops]
    reach = list(itertools.accumulate((e for _, e in ops), max))

    def at(t: float) -> bool:
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and reach[k] > t
    return at


def split(trace) -> dict:
    """The idle time (us) of each of ``CLASSES``; they sum to the gaps'."""
    frames, solves = Holder(port_spans(trace, FRAME)), Holder(port_spans(trace, SOLVE))
    stalled = profiler_open(trace)
    out = dict.fromkeys(CLASSES, 0.0)
    for g0, g1, span in innermost(trace):
        if span is None or stalled(g0):
            out["other"] += g1 - g0
        elif solves.holding(span[0], span[1]):
            out["solve"] += g1 - g0
        elif frames.holding(span[0], span[1]):
            out["scheduler"] += g1 - g0
        else:
            out["other"] += g1 - g0
    return out


def idle_pct(trace, cls: str):
    """The idle time of class ``cls`` over the profiled window, in %; None
    without device intervals or without CGNR frames."""
    if not trace.device or sched_frames(trace) is None:
        return None
    w0, w1 = trace.window
    return 100.0 * split(trace)[cls] / (w1 - w0)


def main(argv=None, root=None) -> int:
    p = argparse.ArgumentParser(description="The CGNR frame's idle split and host time by span.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec, traffic
    from benchmark import trace as tr
    from benchmark.program import Program

    root = root or spec.HERE
    cell = spec.load_cell(args.workload, root)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    geo = traffic.geometry(cell)
    program = Program(cell.recon, cell.config["precision"], device)
    indata = traffic.make_input(geo, args.seed, device)
    program.series(indata)
    n = traffic.traced_series(cell, geo)
    t = tr.reduce(tr.profile(lambda _: program.series(indata), n), geo)
    w0, w1 = t.window
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "series": len(t.series),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "idle_pct": 100.0 * (1 - t.busy_us() / (w1 - w0)) if t.device else None,
        "idle_pct_by_class": ({k: 100.0 * v / (w1 - w0) for k, v in split(t).items()}
                              if t.device else None),
        "host_ms_per_frame": host_split(t),
        "metrics": {m: spec.metric_reader(m, root)(t) for m in READERS},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
