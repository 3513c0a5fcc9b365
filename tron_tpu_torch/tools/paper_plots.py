"""Paper-figure pipeline on the card (counterpart of `scripts/paper_plots.py`,
the rebuild of the reference's figure layer: `src/paper_plots.m`,
`src/whole_body_mosaic.m`, and the timing bar chart and SSIM table of
`src/RUNME4_others_grid_slcmt.m:200-312`).

    python -m tron_tpu_torch.tools.paper_plots [--measure] [--device 0|cpu]

Produces, under output/figs_torch/ (output/figs/ holds the JAX package's
results and is not written):
  timings.csv + timing_bars.png   recon seconds per dataset class, measured
                                  on the card, beside the reference's
                                  published paper-GPU seconds (BASELINE.md;
                                  RUNME4:219, RUNME5:145, RUNME6:147,
                                  RUNME7:146)
  ssim_table.png                  output/torch/dataset_metrics.csv rendered
                                  (the analog of RUNME4's SSIM table)
  whole_body_mosaic.png           tiled frames of the full-scale recon
                                  (src/whole_body_mosaic.m)

`--measure` times the four classes on the device `--device` names (the
card, unless `cpu` is asked for); without it the figures are drawn from an
existing timings.csv.  Each run is `recon_frames` on data already on the
device plus a scalar checksum read back (`.abs().sum().item()`, the
counterpart of the JAX script's fused program and scalar readback): one
warm-up, one more, then the mean of 3 runs on the host clock, with CUDA
events beside it.  The figures need matplotlib, imported only by the
functions that draw; where it is not installed (the card's machine) main
measures and leaves them out.
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import os
import sys
import time

import numpy as np
import torch

FIGDIR = "output/figs_torch"

# (label, reference seconds, nc, nro, undersamp, slide (0 = non-overlapping),
# npe1, golden): the paper-GPU numbers compared against, and the geometry of
# scripts/paper_plots.py:43-49.  whole_body is the exact reference geometry;
# the other three are same-class stand-ins (the reference's datasets are
# git-lfs-only, so their true dims are unrecoverable).
DATASETS = [
    ("whole_body", 3.28, 6, 512, 0.4, 21, 20271, True),
    ("swallowing", 0.92, 4, 256, 0.5, 21, 3000, True),
    ("linear_phantom", 0.76, 1, 512, 1.0, 512, 512, False),
    ("optic_nerve", 0.32, 4, 256, 0.5, 0, 2176, True),
]

FIELDS = ["dataset", "frames", "card_s", "ref_gpu_s", "speedup", "card_msamples_per_s",
          "card", "power_limit_w"]

# categorical identity, fixed order: measured = blue, reference paper-GPU =
# neutral gray; a CVD-safe pair, direct-labeled so identity never rides on
# color alone
C_CARD = "#4477AA"
C_REF = "#9a9a9a"


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def class_case(dataset: tuple, rng: np.random.Generator):
    """One class of DATASETS -> (cfg, work, slide, nz, data): its recon
    config and frame geometry, and its (nc, npe1, nro) complex64 samples,
    drawn next from ``rng``."""
    from tron_tpu_torch.config import ReconConfig

    _, _, nc, nro, u, slide, npe1, golden = dataset
    cfg = ReconConfig(
        golden_angle=golden,
        angle_scheme=None if golden else "linear_half",
        data_undersamp=u,
        prof_slide=slide,
        adjoint=True,
    )
    work = cfg.npe1work(nro, npe1)
    eff_slide = slide if slide > 0 else work
    nz = max(1, 1 + (npe1 - work) // eff_slide)
    data = (
        rng.standard_normal((nc, npe1, nro)) + 1j * rng.standard_normal((nc, npe1, nro))
    ).astype(np.complex64)
    return cfg, work, eff_slide, nz, data


def measure_timings(csv_path: str, device: torch.device) -> list[dict]:
    """Time every class of DATASETS on ``device`` and write ``csv_path``
    (columns FIELDS).  Returns the rows, each also holding ``event_s`` (CUDA
    events over the same runs; None on the CPU), ``grid_launches`` (gridding
    kernel launches over the class's five runs) and ``checksum`` (the first
    run's sum of |image|)."""
    from tron_tpu_torch.device import describe, synchronize
    from tron_tpu_torch.ops import grid_cuda
    from tron_tpu_torch.recon import recon_frames

    card, power = describe(device)
    power_w = power.removesuffix(" W")
    rng = np.random.default_rng(0)
    rows = []
    for dataset in DATASETS:
        label, ref_s, nc, nro = dataset[:4]
        cfg, work, eff_slide, nz, data = class_case(dataset, rng)
        d = torch.from_numpy(data).to(device)
        del data

        def run(s):
            return recon_frames(d * s, cfg, work, eff_slide, nz).abs().sum().item()

        launches0 = grid_cuda.LAUNCHES
        checksum = run(1.0)  # the first call builds and loads the kernels
        run(1.0001)
        reps = 3
        synchronize(device)
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for i in range(reps):
            run(1.0 + 0.0001 * i)
        dt = (time.perf_counter() - t0) / reps
        event_s = None
        if device.type == "cuda":
            end.record()
            end.synchronize()
            event_s = start.elapsed_time(end) / reps / 1e3
        msps = nz * nc * nro * work / dt / 1e6
        rows.append({
            "dataset": label,
            "frames": nz,
            "card_s": dt,
            "ref_gpu_s": ref_s,
            "speedup": ref_s / dt,
            "card_msamples_per_s": msps,
            "card": card,
            "power_limit_w": power_w,
            "event_s": event_s,
            "grid_launches": grid_cuda.LAUNCHES - launches0,
            "checksum": checksum,
        })
        events = f", CUDA events {event_s:.6f} s" if event_s is not None else ""
        print(f"{label}: {nz} frames in {dt:.6f} s host clock{events} ({msps:.1f} Msamples/s, "
              f"{ref_s / dt:.2f}x the paper GPU's {ref_s} s) on {card}, {power}", flush=True)
        del d
        if device.type == "cuda":
            torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    with open(csv_path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=FIELDS, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {csv_path}")
    return rows


def timing_bars(csv_path: str, out_png: str) -> str | None:
    if not os.path.exists(csv_path):
        print(f"skip timing bars: {csv_path} missing", file=sys.stderr)
        return None
    with open(csv_path) as fh:
        rows = list(csv.DictReader(fh))
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7.2, 0.85 * len(rows) + 1.6))
    y = np.arange(len(rows))
    card = [float(r["card_s"]) for r in rows]
    ref = [float(r["ref_gpu_s"]) for r in rows]
    power = rows[0]["power_limit_w"]
    power = f"{power} W" if power.replace(".", "", 1).isdigit() else f"power limit {power}"
    h = 0.38
    ax.barh(y - h / 2 - 0.01, card, h, color=C_CARD,
            label=f"PyTorch/CUDA port ({rows[0]['card']}, {power}, measured)")
    ax.barh(y + h / 2 + 0.01, ref, h, color=C_REF, label="CUDA TRON (paper GPU, published)")
    for yi, v in zip(y, card):
        ax.text(v + 0.03, yi - h / 2 - 0.01, f"{v:.3f} s", va="center", fontsize=9)
    for yi, v in zip(y, ref):
        ax.text(v + 0.03, yi + h / 2 + 0.01, f"{v:.2f} s", va="center", fontsize=9)
    ax.set_yticks(y, [r["dataset"] for r in rows])
    ax.invert_yaxis()
    ax.set_xlabel("reconstruction time (s) — lower is better")
    ax.set_xlim(0, max(card + ref) * 1.22)
    ax.spines[["top", "right"]].set_visible(False)
    ax.legend(frameon=False, loc="lower right", fontsize=9)
    ax.set_title("Radial recon time per dataset class", fontsize=11)
    fig.text(
        0.01,
        0.01,
        "whole_body is the exact reference geometry; the other three are "
        "same-class stand-ins (reference datasets are git-lfs-only).",
        fontsize=7,
        color="#666666",
    )
    fig.tight_layout(rect=(0, 0.04, 1, 1))
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def ssim_table(metrics_csv: str, out_png: str) -> str | None:
    if not os.path.exists(metrics_csv):
        print(f"skip ssim table: {metrics_csv} missing", file=sys.stderr)
        return None
    with open(metrics_csv) as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        return None
    cols = [c for c in rows[0] if c not in ("label", "frame")]
    plt = _plt()
    fig, ax = plt.subplots(figsize=(1.4 * (len(cols) + 2), 0.32 * len(rows) + 1.2))
    ax.set_axis_off()
    cells = [[r["label"], r["frame"]] + [r.get(c, "") for c in cols] for r in rows]
    tbl = ax.table(
        cellText=cells,
        colLabels=["dataset", "frame"] + cols,
        loc="center",
        cellLoc="center",
    )
    tbl.auto_set_font_size(False)
    tbl.set_fontsize(8)
    tbl.scale(1, 1.3)
    ax.set_title(
        "Accuracy table — CUDA-kernel recon vs the plain-gridder cross-check "
        "(*_vs_xla) and the exact-DTFT oracle\n(analog of RUNME4's TRON-vs-IRT "
        "SSIM table; reference TRON scored 0.9965)",
        fontsize=9,
    )
    fig.tight_layout()
    fig.savefig(out_png, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_png


def whole_body_mosaic(ra_path: str, out_png: str, nframes: int = 16) -> str | None:
    if not os.path.exists(ra_path):
        print(f"skip mosaic: {ra_path} missing", file=sys.stderr)
        return None
    from tron_tpu_torch.io import ra_read
    from tron_tpu_torch.viz import mosaic

    arr = np.asarray(ra_read(ra_path))  # (1, nt, nx, ny, nz)
    stack = np.moveaxis(arr.reshape(arr.shape[-3:]), -1, 0)  # (nz, ny, nx)
    idx = np.linspace(0, stack.shape[0] - 1, min(nframes, stack.shape[0])).astype(int)
    return mosaic(
        np.abs(stack[idx]).transpose(0, 2, 1),
        out_png,
        title=f"whole-body recon, {len(idx)} of {stack.shape[0]} frames",
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--measure", action="store_true", help="time the datasets on the device")
    p.add_argument("--device", default="0", help="CUDA device index, or 'cpu'")
    p.add_argument("--timings", default=f"{FIGDIR}/timings.csv")
    p.add_argument("--metrics", default="output/torch/dataset_metrics.csv")
    p.add_argument("--mosaic-src", default="output/torch/img_cmt_tron.ra")
    args = p.parse_args(argv)

    if args.measure:
        from tron_tpu_torch.device import parse_device

        measure_timings(args.timings, parse_device(args.device))
    elif not os.path.exists(args.timings):
        # timing runs only under --measure, never implicitly
        print(f"# no {args.timings}; run with --measure (on the card) to time the "
              "datasets — skipping timing bars")
    if importlib.util.find_spec("matplotlib") is None:
        print("# figures left out: matplotlib is not installed")
        return
    os.makedirs(FIGDIR, exist_ok=True)
    made = [
        timing_bars(args.timings, f"{FIGDIR}/timing_bars.png"),
        ssim_table(args.metrics, f"{FIGDIR}/ssim_table.png"),
        whole_body_mosaic(args.mosaic_src, f"{FIGDIR}/whole_body_mosaic.png"),
    ]
    for m in made:
        if m:
            print(m)


if __name__ == "__main__":
    main()
