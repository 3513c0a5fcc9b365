"""Gridding / degridding kernel bench on the card (counterpart of
`scripts/kbench.py`).

Times one whole-body frame geometry (nc 6, nro 512, 204 spokes, 512^2
oversampled grid) through the kernel wrappers, frames looped on
device-resident data with per-frame golden-angle windows sliding by 21, as
the recon runs them:

    python -m tron_tpu_torch.tools.kbench [--frames 64] [--nc 6] [--nro 512]
        [--npe 204] [--op grid|degrid] [--no-windowed] [--batched]
        [--reps 5] [--dtype bfloat16] [--check] [--library]

``--no-windowed`` takes the segmented gridding kernel (B4), ``--batched`` the
tensor-core one (B5: ``KernelTuning(batched=True)``, as ``TRON_BATCHED=1``).
``--library`` times the library formulation in place of the kernels: each
frame's KB interpolation matrix as CSR (built before the timing) through one
``torch.sparse.mm`` (cuSPARSE SpMM), with the wrappers' relayouts around it,
at float32 (`tools/library_call.py`).
``--dtype`` is the precision class the kernels compute (`ops/precision.py`).
Times are CUDA-event times after a warm-up; the kernel that ran is read
from the wrappers' launch counts.  ``--check`` prints frame 0's NRMSE
against the plain torch version at the same class.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from tron_tpu_torch.config import KernelTuning
from tron_tpu_torch.device import resolve_device
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.ops import degrid_cuda, grid_cuda
from tron_tpu_torch.ops.degrid import degrid_radial2d as degrid_plain
from tron_tpu_torch.ops.grid import grid_radial2d as grid_plain
from tron_tpu_torch.ops.precision import MATMUL_DTYPES, bf16
from tron_tpu_torch.trajectory import spoke_angles

KW = 2.0
SLIDE = 21


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tron_tpu_torch.tools.kbench")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--nc", type=int, default=6)
    p.add_argument("--nro", type=int, default=512)
    p.add_argument("--npe", type=int, default=204)
    p.add_argument("--dtype", default="bfloat16", choices=list(MATMUL_DTYPES),
                   help="precision class the kernels compute (the plain version of "
                   "--check computes the same class)")
    p.add_argument("--no-windowed", dest="windowed", action="store_false")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--check", action="store_true", help="NRMSE vs the plain torch version")
    p.add_argument("--op", default="grid", choices=["grid", "degrid"])
    p.add_argument("--batched", action="store_true",
                   help="KernelTuning(batched=True): the tensor-core gridding kernel "
                   "(as TRON_BATCHED=1)")
    p.add_argument("--library", action="store_true",
                   help="one torch.sparse.mm of the KB interpolation matrix per frame in place "
                   "of the kernels (float32; the matrices are built before the timing)")
    return p


def make_case(args, device):
    """Seeded inputs: (frames, nc, npe, nro) samples (grid) or (frames, nc,
    nxos, nxos) grids (degrid), per-frame angles (frames, npe), the op as
    fn(frame) and its plain version."""
    nf, nc, npe, nro = args.frames, args.nc, args.npe, args.nro
    nxos = nro  # gridos 2
    beta = kb_beta(KW, 2.0)
    gen = torch.Generator(device).manual_seed(0)
    angles = torch.stack([spoke_angles(npe, "golden", SLIDE * f, device=device) for f in range(nf)])
    tuning = KernelTuning.from_env()
    if args.batched:
        tuning = dataclasses.replace(tuning, batched=True)
    shape = (nf, nc, npe, nro) if args.op == "grid" else (nf, nc, nxos, nxos)
    x = torch.complex(
        torch.randn(shape, generator=gen, device=device),
        torch.randn(shape, generator=gen, device=device),
    )
    if args.op == "grid":
        def fn(f):
            return grid_cuda.grid_radial2d(
                x[f], angles[f], nxos, KW, beta, matmul_dtype=args.dtype,
                windowed=args.windowed, tuning=tuning,
            )

        cls, round_samples = grid_cuda.gridder_class(nxos, args.dtype, args.windowed)

        def plain(f):
            d = bf16(x[f]) if round_samples else x[f]
            return grid_plain(d, angles[f], nxos, KW, beta, matmul_dtype=cls)
    else:
        def fn(f):
            return degrid_cuda.degrid_radial2d(
                x[f], angles[f], nro, KW, beta, matmul_dtype=args.dtype, wrap=False,
                tuning=tuning,
            )

        dcls = degrid_cuda.degridder_class(nxos, nro, args.dtype)

        def plain(f):
            return degrid_plain(x[f], angles[f], nro, KW, beta, wrap=False, matmul_dtype=dcls)
    if args.library:
        fn = _library_case(args, x, angles, nxos, beta)
    return fn, plain, tuning


def _library_case(args, x, angles, nxos, beta):
    """The library call per frame, complex in and out as the kernel
    wrappers take them (the same relayouts around one sparse product), with
    the frames' matrices built up front."""
    from tron_tpu_torch.tools import library_call as lib

    nro = args.nro
    if args.op == "grid":
        mats = [lib.interp_matrix(angles[f], nxos, nxos, KW, beta, transpose=True)
                for f in range(args.frames)]

        def fn(f):
            planes = grid_cuda.to_sample_planes(x[f], nxos)
            return lib.grid_output(lib.grid_library(planes, mats[f]), nxos)
    else:
        mats = [lib.interp_matrix(angles[f], nxos, nro, KW, beta)
                for f in range(args.frames)]

        def fn(f):
            gplanes = degrid_cuda.to_grid_planes(x[f])
            return lib.degrid_output(lib.degrid_library(gplanes, mats[f]), args.npe, nro)
    return fn


def nrmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.library:  # the library computes float32
        args.dtype = "float32"
    device = resolve_device()
    t0 = time.perf_counter()
    fn, plain, tuning = make_case(args, device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    nf = args.frames

    def run():
        for f in range(nf):
            fn(f)

    run()  # warm-up: builds the kernels on first use
    torch.cuda.synchronize(device)
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        run()
    end.record()
    torch.cuda.synchronize(device)
    s = start.elapsed_time(end) / 1e3 / args.reps
    counts = dict(grid_cuda.LAUNCH_COUNTS, degrid_radial2d=degrid_cuda.LAUNCHES)
    ran = [k for k, v in counts.items() if v]
    ms_frame = 1e3 * s / nf
    msps = nf * args.nc * args.npe * args.nro / s / 1e6
    res = {
        "op": args.op, "frames": nf, "windowed": args.windowed, "batched": tuning.batched,
        "dtype": args.dtype,
        "kernel": "library (torch.sparse.mm)" if args.library else ",".join(ran),
        "launches": counts, "ms_per_frame": ms_frame,
        "library_build_s": build_s if args.library else None,  # inputs and matrices
        "msamples_per_s": msps, "device": torch.cuda.get_device_name(device),
    }
    print(
        f"op={args.op} frames={nf} windowed={args.windowed} dtype={args.dtype} "
        f"batched={tuning.batched} kernel={res['kernel']} launches={sum(counts.values())}: "
        f"{ms_frame:.4f} ms/frame  {msps:.1f} Msamp/s  on {res['device']}",
        flush=True,
    )
    if args.check:
        res["nrmse_vs_plain"] = nrmse(fn(0), plain(0))
        print(f"nrmse_vs_plain: {res['nrmse_vs_plain']:.3e}", flush=True)
        if not math.isfinite(res["nrmse_vs_plain"]):
            raise RuntimeError("kernel output is not finite")
    return res


if __name__ == "__main__":
    main()
