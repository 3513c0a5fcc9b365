"""The readings a cell's correctness limit is set from (`limits/<cell>.json`):
for each seed, the worst frame error of one whole series that the program's
timed entry returns, and that of the control, the plain reference the
cell's mix names with its contraction operands (gridding or degridding)
rounded to float8 e4m3 (the precision below the configuration's bfloat16),
both against the float32 reference on the same input.  The reference at
bfloat16 is read beside them.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--out FILE]

Needs the card, as a run does; one JSON line per seed, then a summary
line with the lower reading (the program's largest) and the upper one (the
control's smallest).  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

QUANTS = ("bfloat16", "float8_e4m3")


def readings(cell, seed: int, device, block: int = 32) -> dict:
    """The program's, the control's and the bfloat16 reference's worst
    frame errors on one series of ``seed``, ``block`` frames at a time."""
    from benchmark import check, spec, traffic
    from benchmark.program import Program

    geo = traffic.geometry(cell)
    indata = traffic.make_input(geo, seed, device)
    program = Program(cell.recon, cell.config["precision"], device)
    served = program.series(indata)
    del program
    ref = spec.reference(cell).Series(indata, cell.recon, device)
    worst = dict.fromkeys(("program",) + tuple("ref_" + q for q in QUANTS), 0.0)
    for b0 in range(0, geo["nz"], block):
        frames = list(range(b0, min(b0 + block, geo["nz"])))
        truth = ref.frames(frames, block=block)
        got = {"program": served[b0:b0 + len(frames)]}
        got.update({"ref_" + q: ref.frames(frames, q, block=block) for q in QUANTS})
        for k, v in got.items():
            e = np.nan_to_num(check.frame_errors(v, truth), nan=np.inf)
            worst[k] = max(worst[k], float(e.max()))
    return {"seed": seed, **worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("error: the control runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, seed, device)
        r["seconds"] = time.perf_counter() - t0
        lines.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": cell.name, "device": torch.cuda.get_device_name(device),
               "seeds": len(lines),
               "lower": max(r["program"] for r in lines),
               "program_median": float(np.median([r["program"] for r in lines])),
               "upper": min(r["ref_float8_e4m3"] for r in lines),
               "ref_bfloat16_max": max(r["ref_bfloat16"] for r in lines)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in lines + [summary]:
                f.write(json.dumps({"workload": cell.name, **r}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
