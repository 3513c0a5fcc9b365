"""Split the fixed per-run cost that floors the small dataset classes'
end-to-end rates (counterpart of `scripts/floor_dissect.py`).

    python -m tron_tpu_torch.tools.floor_dissect [--device 0|cpu]

For each of three classes of `tools/paper_plots.DATASETS` (optic nerve,
linear phantom, swallowing; data from `numpy.random.default_rng(0)`) one
run is `recon_frames` plus a scalar checksum read back
(`.abs().sum().item()`), as paper_plots times it.  Its host-clock wall
splits into:

  rtt       a null op on a 1-element device tensor plus `.item()`: the
            launch and synchronise round trip, the constant no amount of
            kernel work removes;
  device    the slope: K recons back to back with one read back, timed at
            K=1 and K=9 -> (t9 - t1)/8, so the per-call constant cancels.
            The JAX script's premise, one fused program per run, does not
            hold in eager PyTorch: the slope also holds the host's time to
            issue each recon's launches, and where that exceeds the card's
            work it is what the slope measures;
  busy      hence measured as well: the union of the card's busy intervals
            (every kernel, copy and fill) over one recon, from
            torch.profiler, after every class has been timed (a profiler
            session leaves the process's later launches slower); not
            measured on the CPU;
  residual  wall - rtt - device (host relayout, Python).

Beside them, the full-image readback the CLI pays (`.cpu()` of the
complex64 images instead of the checksum) as d2h_ms, with its bytes and
rate.  Timings are medians of 5 after 2 warm-ups, every host clock read
after a synchronise.  Output: a markdown table and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tron_tpu_torch.tools import paper_plots

# the stand-in classes of tools/paper_plots.DATASETS whose per-run constant
# matters (scripts/floor_dissect.py:80-84); whole_body is not floored by it
CLASSES = ("optic_nerve", "linear_phantom", "swallowing")


def _timer(fn, reps=5, warm=2):
    """(min, median) host wall of fn over reps calls after warm calls; fn
    ends in a read back, so each call's clock stops after the device."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[0], ts[len(ts) // 2]


def busy_ms(fn, device: torch.device) -> float | None:
    """Milliseconds in which the card is busy during one call of fn: the
    union of the device intervals the profiler records (the port's spans,
    which the trace mirrors on the device, left out).  None on the CPU."""
    if device.type != "cuda":
        return None
    from tron_tpu_torch.tracing import SPANS as ranges

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize(device)
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in ranges
    )
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3  # profiler times are in us


def _recon_k(case: tuple, d: torch.Tensor, k: int) -> float:
    """k recons of one class back to back, one read back; a per-step scale
    keeps every step's work distinct.  ``case`` is the class's (cfg, work,
    slide, nz), ``d`` its (nc, npe1, nro) data."""
    from tron_tpu_torch.recon import recon_frames

    acc = torch.zeros((), device=d.device)
    for i in range(k):
        acc += recon_frames(d * (1.0 + 1e-4 * i), *case).abs().sum()
    return acc.item()


def dissect_class(label: str, case: tuple, d: torch.Tensor, rtt_s: float) -> dict:
    """The split of one class's run; ``busy_ms`` and ``busy_pct`` are left
    None for main to fill once every class is timed."""
    from tron_tpu_torch.recon import recon_frames

    _, work, _, nz = case
    nc, _, nro = d.shape
    nsamp = nz * nc * nro * work
    t1 = _timer(lambda: _recon_k(case, d, 1))[1]
    t9 = _timer(lambda: _recon_k(case, d, 9))[1]
    dev_s = (t9 - t1) / 8.0
    timg = _timer(lambda: recon_frames(d * 1.0, *case).cpu())[1]
    shape = recon_frames(d, *case).shape  # (nz, n, n) complex64
    d2h_bytes = 8 * int(np.prod(shape))
    d2h_s = max(timg - t1, 0.0)
    resid = t1 - rtt_s - dev_s
    row = {
        "class": label,
        "frames": nz,
        "wall_ms": round(t1 * 1e3, 3),
        "rtt_ms": round(rtt_s * 1e3, 3),
        "device_ms": round(dev_s * 1e3, 3),
        "busy_ms": None,
        "residual_ms": round(resid * 1e3, 3),
        "rtt_pct": round(100 * rtt_s / t1, 1),
        "device_pct": round(100 * dev_s / t1, 1),
        "busy_pct": None,
        "e2e_msamples_per_s": round(nsamp / t1 / 1e6, 1),
        "device_msamples_per_s": round(nsamp / dev_s / 1e6, 1) if dev_s > 0 else None,
        "d2h_ms": round(d2h_s * 1e3, 3),
        "d2h_mb": round(d2h_bytes / 1e6, 3),
        "d2h_gbps": round(d2h_bytes / d2h_s / 1e9, 2) if d2h_s > 0 else None,
    }
    print(f"{label}: wall {t1 * 1e3:.3f} ms = rtt {rtt_s * 1e3:.3f} + device {dev_s * 1e3:.3f} "
          f"+ residual {resid * 1e3:.3f} (K=9 {t9 * 1e3:.3f} ms; image readback "
          f"+{d2h_s * 1e3:.3f} ms for {d2h_bytes / 1e6:.3f} MB)", flush=True)
    return row


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="0", help="CUDA device index, or 'cpu'")
    args = p.parse_args(argv)

    from tron_tpu_torch.device import describe, parse_device

    device = parse_device(args.device)
    card, power = describe(device)
    print(f"device: {card}, {power}")

    # the round trip: a null op on one element, read back
    one = torch.ones(1, device=device)
    rtt_min, rtt_med = _timer(lambda: (one * 2.0).item(), reps=20)
    print(f"null op round trip: min {rtt_min * 1e3:.3f} ms / med {rtt_med * 1e3:.3f} ms")

    rng = np.random.default_rng(0)
    cases = []
    for label in CLASSES:
        dataset = next(ds for ds in paper_plots.DATASETS if ds[0] == label)
        *case, data = paper_plots.class_case(dataset, rng)
        cases.append((label, tuple(case), torch.from_numpy(data).to(device)))
    rows = [dissect_class(label, case, d, rtt_med) for label, case, d in cases]
    # the profiler last, once every class is timed
    for row, (label, case, d) in zip(rows, cases):
        busy = busy_ms(lambda: _recon_k(case, d, 1), device)
        if busy is not None:
            row["busy_ms"] = round(busy, 3)
            row["busy_pct"] = round(100 * busy / row["wall_ms"], 1)
        print(f"{label}: card busy {'not measured' if busy is None else f'{busy:.3f} ms'} "
              f"in one run", flush=True)
    del cases
    if device.type == "cuda":
        torch.cuda.empty_cache()

    print()
    hdr = list(rows[0])
    print("| " + " | ".join(hdr) + " |")
    print("|" + "---|" * len(hdr))
    for r in rows:
        print("| " + " | ".join(str(r[k]) for k in hdr) + " |")
    print()
    out = {"device": card, "power_limit": power, "rtt_ms_med": round(rtt_med * 1e3, 3),
           "classes": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
