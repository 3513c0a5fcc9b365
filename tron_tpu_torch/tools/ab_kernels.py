"""The float32 kernels of two checkouts side by side on one card: output
bits, registers and device time; and B3 under wrap at bf16x2 and bf16x3,
with a forward frame at bf16x3.

Run by path, once per checkout, then compare; each run imports the
`tron_tpu_torch` of ``--root`` (so it can time an older checkout's kernels,
through the wrapper calls both share) and builds that checkout's kernels
there on first use:

    python tron_tpu_torch/tools/ab_kernels.py --root OLD --out old.npz
    python tron_tpu_torch/tools/ab_kernels.py --root .   --out new.npz
    python tron_tpu_torch/tools/ab_kernels.py --compare old.npz new.npz [more.npz ...]

Each run grids and degrids seeded whole-body inputs (6 coils, nro 512, 204
spokes, nxos 512) through B1 (integer radii and the exact lattice), B5, B4
and B3 (kw 2 and 4) at matmul_dtype="float32", B3 under wrap at bf16x2 and
bf16x3 (where a checkout may recompute the wrap-edge readouts at float32)
and one whole-body forward frame at bf16x3 (6 x 256^2 images, 512 spokes of
512 readouts; its Msamples/s printed), and saves the outputs, the
device ms per call (CUDA events over 50 calls after a warm-up) and ptxas's
registers per float32 instantiation (from a build in this run; a reused
library has no log).  ``--compare`` prints one JSON line: per kernel whether
the outputs are bitwise equal and the readouts (last-axis indices) where
they differ, each run's ms, and the registers of the
instantiations both builds have.  Instantiations are named by kernel and
template arguments; a later source's precision-class argument (float32) and
rounded-weights flag (off) are dropped so that the names meet.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

FLOAT32 = "3"  # the float32 class code (csrc/precision.cuh)


def _entries(log: str) -> dict:
    """{(kernel, template args): registers} of one build's ptxas -v log,
    float32 instantiations only, in the older naming."""
    regs, name = {}, None
    for ln in log.splitlines():
        # the kernel's name follows its length, after the anonymous namespace
        m = re.search(r"Compiling entry function '\w*?\d((?:de)?grid_\w*?_kernel)"
                      r"(I(?:L[ib]\d+E)+E)?", ln)
        if m:
            args = re.findall(r"L([ib])(\d+)E", m.group(2) or "")
            kernel = m.group(1)
            if re.search(r"contract|mma|degrid", kernel) and args and args[-1][0] == "i" \
                    and len(args) > (3 if "degrid" in kernel else 1):
                if args[-1][1] != FLOAT32:
                    name = None
                    continue
                args = args[:-1]
            bools = [v for t, v in args if t == "b"]
            if len(bools) == 2:  # (lattice, rounded weights)
                if bools[1] != "0":
                    name = None
                    continue
                args = [a for i, a in enumerate(args) if not (a[0] == "b" and i == len(args) - 1)]
            name = f"{kernel}<{','.join(v for _, v in args)}>"
        elif name and "registers" in ln:
            regs[name] = int(re.search(r"Used (\d+) registers", ln).group(1))
            name = None
    return regs


def run(root: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from tron_tpu_torch import _build
    from tron_tpu_torch.config import KernelTuning
    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.kernels.kb import kb_beta
    from tron_tpu_torch.nufft import nufft_forward
    from tron_tpu_torch.ops import degrid_cuda, grid_cuda
    from tron_tpu_torch.trajectory import spoke_angles

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels needs a CUDA device")
    dev = torch.device("cuda", 0)
    built = _build.load()
    rng = np.random.default_rng(0)
    planes = torch.from_numpy(rng.standard_normal((204, 512, 12), dtype=np.float32)).to(dev)
    cplx = (rng.standard_normal((6, 204, 512)) + 1j * rng.standard_normal((6, 204, 512)))
    data = torch.from_numpy(cplx.astype(np.complex64)).to(dev)
    g = (rng.standard_normal((6, 512, 512)) + 1j * rng.standard_normal((6, 512, 512)))
    grid = torch.from_numpy(g.astype(np.complex64)).to(dev)
    ang = spoke_angles(204, "golden", 19000, device=dev)
    beta, b4 = kb_beta(2.0, 2.0), kb_beta(4.0, 2.0)
    grid4 = grid * (8.0 / float(np.i0(b4))) ** 2  # keeps the kw 4 weight products finite
    im = rng.standard_normal((6, 256, 256)) + 1j * rng.standard_normal((6, 256, 256))
    img = torch.from_numpy(im.astype(np.complex64)).to(dev)
    fang = spoke_angles(512, "golden", 0, device=dev)
    fcfg = ReconConfig(golden_angle=True, data_undersamp=1.0, matmul_dtype="bf16x3")
    calls = {
        "B1": lambda: grid_cuda.grid_radial2d_planes(planes, ang, 512, 2.0, beta),
        "B1 exact lattice": lambda: grid_cuda.grid_radial2d_exact(data, ang, 512, 2.0, beta),
        "B5": lambda: grid_cuda.grid_radial2d_planes(planes, ang, 512, 2.0, beta,
                                                     tuning=KernelTuning(batched=True)),
        "B4": lambda: grid_cuda.grid_radial2d_planes(planes, ang, 512, 2.0, beta,
                                                     windowed=False),
        "B3": lambda: degrid_cuda.degrid_radial2d(grid, ang, 512, 2.0, beta, wrap=False),
        "B3 kw 4": lambda: degrid_cuda.degrid_radial2d(grid4, ang, 512, 4.0, b4, wrap=False),
        "B3 bf16x2 wrap": lambda: degrid_cuda.degrid_radial2d(grid, ang, 512, 2.0, beta,
                                                              matmul_dtype="bf16x2"),
        "B3 bf16x3 wrap": lambda: degrid_cuda.degrid_radial2d(grid, ang, 512, 2.0, beta,
                                                              matmul_dtype="bf16x3"),
        "forward bf16x3": lambda: nufft_forward(img, fang, fcfg, nro=512),
    }
    res = {}
    for name, fn in calls.items():
        y = fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            fn()
        end.record()
        torch.cuda.synchronize()
        res[f"out {name}"] = y.cpu().numpy()
        res[f"ms {name}"] = np.float64(start.elapsed_time(end) / 50)
    res["registers"] = np.array(json.dumps(_entries(built.log)))
    res["device"] = np.array(torch.cuda.get_device_name(0))
    np.savez(out, **res)
    msps = 6 * 512 * 512 / float(res["ms forward bf16x3"]) / 1e3
    print(f"{root}: {', '.join(f'{k[3:]} {float(v):.4f} ms' for k, v in res.items() if k[:3] == 'ms ')}"
          f"; forward bf16x3 {msps:.1f} Msamples/s on {res['device']}", flush=True)


def _differ(a: np.ndarray, b: np.ndarray):
    """The last-axis indices (readouts, or grid columns) at which two outputs
    differ in any bit: a list of up to 32, else their count."""
    if a.shape != b.shape:
        return "shapes differ"
    cols = np.flatnonzero((a != b).reshape(-1, a.shape[-1]).any(axis=0)).tolist()
    return cols if len(cols) <= 32 else len(cols)


def compare(paths: list[str]) -> dict:
    runs = [np.load(p) for p in paths]
    kernels = [k[4:] for k in runs[0].files if k.startswith("out ")]
    regs = [json.loads(str(r["registers"])) for r in runs]
    built = [r for r in regs if r]
    common = sorted(set.intersection(*map(set, built))) if len(built) > 1 else []
    line = {
        "runs": paths,
        "device": str(runs[0]["device"]),
        "kernels": {
            k: {
                "bitwise_equal": [bool(np.array_equal(runs[0][f"out {k}"], r[f"out {k}"]))
                                  for r in runs[1:]],
                "readouts_that_differ": [_differ(runs[0][f"out {k}"], r[f"out {k}"])
                                         for r in runs[1:]],
                "ms": [float(r[f"ms {k}"]) for r in runs],
            }
            for k in kernels
        },
        "registers": {n: [r.get(n) for r in regs] for n in common},
        "registers_equal": all(len({r[n] for r in built}) == 1 for n in common),
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python tron_tpu_torch/tools/ab_kernels.py")
    p.add_argument("--root", help="the checkout whose kernels this run builds and times")
    p.add_argument("--out", help="the .npz this run writes")
    p.add_argument("--compare", nargs="+", metavar="NPZ", help="compare runs (the first is the base)")
    args = p.parse_args(argv)
    if args.compare:
        compare(args.compare)
    else:
        run(args.root, args.out)


if __name__ == "__main__":
    main()
