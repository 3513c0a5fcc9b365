"""The benchmark of tron_tpu_torch: one cell, one run, one result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In one process, in this order: load the port (on a checkout's first run its
kernels are built), make the cell's input from the seed, warm up with one
whole series, then run series back to back for ``--seconds`` in a closed
loop, one researcher with one card: each series is one call of
`tron_tpu_torch.recon.recon_radial2d`, host memory to host memory (samples
to images, or images to samples where the mix runs the forward), timed by
the host clock around the call.  Once the window has closed the kept
frames are compared with those of the plain reference the mix names
(`check.py`), and the last line of standard output is one JSON object.

``--trace 0`` reports the cell's end-to-end metrics.  ``--trace 1``
profiles whole series at the start of the window (again, at most three
times in all, when the profile holds no device kernel or, of a kernel the
port's counters saw launched, fewer than they counted) and reports the
per-layer metrics that `metrics/<name>.py` read from it, with the device's
busy time and a breakdown.  A card is needed: without one, or with fewer
than the cell asks for, the run exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "tron_tpu")


def since_process_start() -> float:
    """Seconds since this process started, by the kernel's record of it."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its kin's, or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_memory() -> dict:
    """This process's page faults so far and its peak resident size."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"minflt": ru.ru_minflt, "majflt": ru.ru_majflt, "maxrss_kB": ru.ru_maxrss}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def end_to_end(name: str, times: list, span: float, completed: int, geo: dict,
               setup_s: float) -> float:
    from benchmark import traffic

    if name == "msamples_per_s":
        return completed * traffic.series_samples(geo) / span / 1e6
    if name == "series_p95_s":
        return float(np.percentile(times, 95))
    if name == "setup_s":
        return setup_s
    raise KeyError(f"the harness has no end-to-end metric {name!r}")


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell`` on ``device``: the result line's object."""
    import torch

    from benchmark import check, spec, traffic
    from benchmark import trace as tr
    from benchmark.program import Program

    geo = traffic.geometry(cell)
    program = Program(cell.recon, cell.config["precision"], device)
    log(f"port loaded: {since_process_start():.3f} s")
    indata = traffic.make_input(geo, seed, device)
    log(f"input {indata.shape} {indata.nbytes / 1e6:.1f} MB: {since_process_start():.3f} s")
    program.series(indata)
    plan = traffic.CheckPlan(cell, geo, seed)

    times, kept, failed = [], {}, set()
    last = None
    state = {"i": 0}

    def one(_=None):
        nonlocal last
        i = state["i"]
        state["i"] += 1
        t0 = time.perf_counter()
        try:
            out = program.series(indata)
        except Exception as e:  # a series that raises is failed; the window goes on
            failed.add(i)
            log(f"series {i} raised {type(e).__name__}: {e}")
            return
        times.append(time.perf_counter() - t0)
        ends.append(time.perf_counter())
        # the whole output is held only until the series kept whole has run
        last = (i, out) if i < plan.whole else None
        idx = plan.frames(i)
        kept[i] = (idx, out[idx] if len(idx) < geo["nz"] else out)

    ends = []
    log(f"host before the window: {host_memory()}")
    setup_s = since_process_start()
    t_start = time.perf_counter()
    traced = None
    if trace:
        n = traffic.traced_series(cell, geo)
        for attempt in range(3):
            before = program.counters()
            events = tr.profile(one, n)
            counters = {k: v - before[k] for k, v in program.counters().items()}
            traced = tr.reduce(events, geo)
            got = {k: traced.kernel_us((k,))[1] for k in counters}
            short = [k for k in counters if got[k] < counters[k]]
            if len(traced.series) == n and traced.kernels() and not short:
                break
            log(f"trace: profile {attempt + 1} of {n} series held {len(traced.kernels())} "
                f"kernels, launches by the counters {counters}, in the profile {got}; "
                + ("profiling again" if attempt < 2 else "giving up"))
            traced = None
    while time.perf_counter() - t_start < seconds:
        one()
    span = (ends[-1] if ends else time.perf_counter()) - t_start
    attempted = state["i"]
    if last is not None and last[0] < plan.whole:
        kept[last[0]] = (np.arange(geo["nz"]), last[1])
    log(f"window: {attempted} series in {span:.3f} s, {len(failed)} raised; series s: "
        + (f"min {min(times):.4f} median {float(np.median(times)):.4f} max {max(times):.4f}"
           if times else "none"))
    log(f"host after the window: {host_memory()}")
    log("series s: " + " ".join(f"{t:.4f}" for t in times))

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0),
           "power_limit": power_limit() if device.type == "cuda" else "not measured"}
    metrics, breakdown = {}, None
    if trace:
        if traced is not None:
            w0, w1 = traced.window
            dev["busy_s"] = traced.busy_us() / 1e6
            dev["window_s"] = (w1 - w0) / 1e6
            breakdown = traced.breakdown()
            for m in cell.per_layer:
                v = spec.metric_reader(m["name"], cell.root)(traced)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            log(f"trace: {len(traced.series)} series, {traced.frames} frames, "
                f"{traced.launches} launch calls, kernel launches by the counters {counters}, "
                f"in the profile {got}")
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], times, span, len(times), geo,
                                                      setup_s), "unit": m["unit"]}

    # the reference, once the program's state is freed
    del last, program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    limit = cell.limits["frame_rel_err"]["limit"]
    res = check.compare(indata, spec.reference(cell), cell.recon, kept, device)
    bad = {i for i, w in res["worst"].items() if not w <= limit}
    worst = max(res["worst"].values(), default=float("nan"))
    log(f"reference: {res['frames']} frames of {len(kept)} series compared in "
        f"{time.perf_counter() - t_ref:.3f} s")
    failed |= bad
    correct = attempted > 0 and not failed and len(kept) == len(times)
    checks = {"frame_rel_err": {"value": worst if np.isfinite(worst) else str(worst),
                                "limit": limit},
              "failed_series": {"value": len(failed), "limit": 0}}
    result = {"correct": correct, "attempted": attempted, "failed": len(failed),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"error: the cell needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import tron_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"error: the program under test is missing: {e}")
        return 2
    # matmuls at the precision they state: the reference's float32 stays float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"error: the run loaded {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
