#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tron_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA device

Phases, one line each (any failure raises and exits non-zero):
  1 env      card name and power limit, torch and CUDA versions
  2 build    nvcc builds csrc/*.cu for sm_90a into build/tron_tpu_torch/;
             ptxas registers and spills per kernel and precision class; the
             library's SASS holds tensor-core MMAs in B5's contraction (bf16
             at the bf16 classes, TF32 at float32) and bulk copies in B4's;
             g++ builds the .ra helper (_native/ra_native.cpp), its bytes and
             float16 conversion held to the Python path and numpy
  3 kernel   the CUDA gridding kernel (the tile kernel) vs its plain torch
             version on the card
  4 main     whole-body golden-angle sliding-window recon (6 coils, nro 512,
             204 spokes per frame, slide 21, 956 frames of 256^2) through
             recon_radial2d at the default class (bfloat16, as `tron -a -G
             -u 0.4 -d 21`), direct and incremental, with launch counts;
             frames 0-2 vs the plain version at bfloat16 and vs float32
  5 golden   the committed JAX-computed golden images
  6 cli      tron-torch -a -G -u 0.4 -d 21 on a .ra fixture
  7 timing   throughput (CUDA events), kernel vs plain ms per frame and the
             tile kernel's four passes in the profiler
  8 degrid   the CUDA degridding kernel vs its plain torch version (wrap and
             clip; nxos 64-640, 1-10 coils, gridos 1.5/2/2.5, an odd nro; kw 4
             and 6.5, the wide instantiation); at bf16x2 and bf16x3 under wrap
             (nxos 256 and 512) the wrap-edge readouts bit for bit the float32
             kernel's, the rest the class kernel's, in two launches
  9 exact    the gridding kernel's exact lattice vs the plain raw-rows gridder
 10 dot      dot test of the kernel pair at gridos 1.5, 2, 2.5, and at kw 4, 6.5
 11 forward  forward recon_radial2d at full width (32 frames of 6-coil 256^2,
             -G -u 1: 512 spokes of 512 readouts), with launch counts, at
             float32 and at bf16x3 (--precision accurate: two launches a
             frame, the wrap-edge readouts the float32 run's bit for bit)
 12 cgnr     -a -G -u 0.4 -d 21 -i 10 on the whole-body series, with launch
             counts, vs plain-operator CGNR; --toeplitz on 8 frames (one
             gridded multiplier a frame, solver.TOEPLITZ_COUNTS; each solve's
             prologue replayed after a geometry's first,
             solver.CGNR_PROLOGUE_COUNTS)
 13 solver   6-coil birdcage Shepp-Logan 256^2: CGNR beats the adjoint and
             its data residual falls
 14 cli2     tron-torch forward and -i 4 on .ra fixtures
 15 timing2  degrid kernel vs plain ms (the wrapper, and the bare C call),
             forward Msamples/s, CGNR ms per frame; at bf16x3 the forward and
             B3 per call (bf16x2 too) with and without the wrap-edge launch
 16 seg      the segmented gridding kernel (windowed=False, B4) within 1e-6
             of the tile kernel (B1), B4, B1 and the tensor-core kernel
             (tuning.batched, B5) each within 1e-5 of its plain version, each
             repeat run bitwise (nxos 8-640, C 1-10, golden and linear-half
             angles, signed data, both lattices, segments of 3-32 rows); B4
             timed beside B1 on a whole-body frame, its four passes in the
             profiler
 17 batched  the same checks at kw 1.5/2/3 on both lattices; B5 timed
             beside B1, its four passes in the profiler
 18 stream   tron-torch -a -G -u 0.4 -d 21 --stream on the whole-body series
             written to a .ra (twice), with --incremental, --half and
             TRON_BATCHED=1, each vs the in-memory recon, with launch counts
             by kernel, the .ra helper's region reads and writes, and the
             host wall from file to file; then its stages alone (the read
             stage through the helper and through Python) and the card's
             busy share over one profiled run
 19 kbench   python -m tron_tpu_torch.tools.kbench: default, --no-windowed,
             --batched and --op degrid (bfloat16, the default --dtype), and
             default and --batched at --dtype float32, each with --check, at
             whole-body; each one's device time per frame by kernel in the
             profiler
 20 koosh    -3 stack of stars at whole-body width (6 coils, nro 512, 816 spokes,
             -u 0.4: 4 in-plane frames of 204; 32 kz encodings; 642 MB) through
             recon_radial2d: adjoint (128 images) and forward (32 slices of
             6x256^2, -G -u 1), with launch counts; slices vs the plain operators
             on a host-side kz transform; nt 2 at a smaller depth; device ms
 21 kstream  tron-torch -3 -a -G -u 0.4 --stream on the same stack from a .ra,
             also with --half and TRON_BATCHED=1, each vs the in-memory -3
 22 walsh    --combine walsh on 64 whole-body frames; Walsh vs a float64 dense
             eigen-solve on 2 frames of the 6-coil phantom; --compress 3 in
             memory vs --stream --compress 3; Walsh ms per frame
 23 cli3     tron-torch -B/-T, --scheme linear_half roundtrip of
             tools.make_phantom, -k 4 forward and -i 2, --backend pallas,
             --precision accurate, --profile DIR, -k 7 (exit 2), and the
             golden-angle fixture of tools.make_goldenangle at nxos 128
 24 shard1   the sharded scheduler (parallel.recon_frames_sharded) at a world
             of 1 on NCCL, a 1 x 1 mesh: the whole-body series, direct and
             incremental, bitwise against recon_frames and
             recon_frames_incremental, ms per frame side by side, launch counts
 25 shard2   two ranks that share the card (gloo on CUDA tensors; with two
             cards also NCCL, one card each), started through parallel.launch,
             whole-body width: recon_frames_sharded on 64 frames over meshes
             (2, 1) and (1, 2), sum of squares, Walsh (on the 6-coil phantom)
             and coil images (16 frames), direct and incremental;
             recon_window_spoke_sharded on a 2-rank spoke mesh, adjoint, -i 10
             and -i 10 --toeplitz; recon_forward_sharded on 32 slices, 2-D and
             -3; recon_stack_of_stars_sharded on the stack of phase 20; each
             against the unsharded recon, repeats bitwise, every rank holding
             the whole result, with the ranks' launch counts
 26 clishard tron-torch --shard, --shard-spokes and --stream --shard on the
             1479-spoke cut, in this process and as two ranks on the card, each
             against the unsharded file
 27 classes  tools.paper_plots.measure_timings on the paper's four dataset
             classes at full size (whole-body, swallowing, linear phantom,
             optic nerve): s per series on the host clock and CUDA events,
             Msamples/s, speed-up over the paper GPU's published s, launches;
             each class's first frame vs the plain operators
 28 floor    tools.floor_dissect: the per-run wall of the three small classes
             split into round trip, slope and residual, with the card's busy
             time from the profiler and the image readback
 29 incdis   tools.inc_dissect on the 956 whole-body frames: the incremental
             path, its gridding alone and its epilogue alone
 30 runme    scripts/torch_RUNME1, torch_RUNME2 and torch_RUNME3
             (TRON_FULLSCALE=0), each command a process of its own: exit
             codes, the files' dims as the JAX recipes give them, the
             recipes' metric and comparison tables
 31 precision the four precision classes at whole-body width (6 coils,
             nro 512, 204 spokes, nxos 512) in B1, B5, B4 and B3 (kw 2 and
             4), and B2's rule on B1's kernel at nxos 128: each kernel vs its
             plain version at the same class on the card, its error against
             the float32 plain version beside the plain version's own, a
             repeat bitwise, B2's and B4's class rules, device ms per class;
             B3's rule (float32 at every class on a grid that does not tile
             and at an odd nro, bit for bit) at n 128 and at nro 255
 32 library  the kernels' function as one torch.sparse.mm of the KB
             interpolation matrix as CSR (cuSPARSE SpMM, tools/library_call):
             B1 on both lattices and B3 clip and wrap at whole-body width, B2
             at nxos 128; each vs its plain version, a repeat, kernel,
             library, library, kernel in turns at float32, device time in
             the profiler, its bound, nonzeros, index width, build ms, and a
             bfloat16 try; kbench --library (grid and degrid)
 33 bench    python -m tron_tpu_torch.bench in a process of its own, at full
             size: its twelve sections' line logged, then held to platform
             gpu, no errors, every key present and finite, route "kernel" and
             launches of B1 (and B3) in each section that runs them, and the
             NRMSE limits of incremental, bf16, accurate and the JAX golden
Phases whose references are fp32 (the JAX goldens, the forward, CGNR and
solver checks, the -3 forward, the dot tests, the classes' frame 0) pin
matmul_dtype="float32"; the CLI phases compare like with like.
Then the kernel table as one JSON line (each kernel's launches on its main
paths, phase 33's counted by the bench per section, the recipes' processes
of phase 30 left uncounted; error, ms, the
passes' device ms, plain ms, bound, and per class the device ms, the error
against the plain version and the bound; phase 32's library call, its
device ms, bound, nonzeros and build ms; B1, B4 and B5 share the gridding
call, since they compute one function), the
nvidia-smi line, and the result line {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NC, NRO, SLIDE, NZ = 6, 512, 21, 956  # whole-body class (bench.py:168-174)
KERNEL_TOL = 1e-5                     # kernel vs plain, NRMSE (fp32 sums in two orders)
CLASSES = ("bfloat16", "bf16x2", "bf16x3", "float32")  # precision classes (ops/precision.py)
SEG_TOL = 1e-6                        # B4 vs B1: B1's fp32 terms, regrouped at work items
INC_TOL = 1e-4                        # incremental vs direct worst frame (bench.py:266)
CG_TOL = 1e-4                         # CGNR, kernels vs plain operators (tests/test_torch_solver.py)
DOT_TOL = 1e-4                        # pair dot test (tests/test_grid_pallas.py:419)
NITER = 10                            # CGNR iterations of the main path (-i 10)
NF = 32                               # forward frames
CG_WALL = 120.0                       # s; above it the CGNR path takes the first 128 frames
BENCH_WALL = 480.0                    # s; phase 33's bench process is killed after it
BENCH_KEYS = (                        # the bench line's keys, one section per row (bench.py's names)
    "value", "vs_baseline", "frames_per_s", "frames", "seconds_per_run",
    "incremental_msamples_per_s", "nrmse_incremental_vs_direct", "direct_msamples_per_s",
    "headline_mode",
    "nrmse_bf16_vs_fp32", "nrmse_accurate_vs_fp32", "nrmse_fp32_vs_jax_golden",
    "accurate_msamples_per_s", "accurate_frames",
    "koosh_slices_per_s", "koosh_slices_per_s_e2e", "koosh_slices_per_s_e2e_half",
    "degrid_msamples_per_s", "degrid_frames",
    "adjoint_msamples_per_s_osf15", "adjoint_msamples_per_s_osf25",
    "degrid_msamples_per_s_osf15", "degrid_msamples_per_s_osf25",
    "adjoint_msamples_per_s_kw3",
    "cgnr_pair_s_per_iter", "cgnr_toeplitz_s_per_iter",
    "cgnr_series_adjoint_wall_s", "cgnr_series_pair_wall_s", "cgnr_series_toeplitz_wall_s",
    "cgnr_series_adjoint_nrmse_truth", "cgnr_series_pair_nrmse_truth",
    "cgnr_series_toeplitz_nrmse_truth", "cgnr_series_frames",
    "walsh_ms_per_frame",
    "stream_wall_s", "stream_wall_s_all", "stream_wall_compress3_s",
    "stream_wall_compress3_s_all", "stream_fixture", "stream_frames",
    "direct_bound_ms", "direct_roofline_pct",
)
BENCH_KERNELS = {                     # kernel -> the bench sections that must launch it
    "grid_radial2d": ("throughput", "incremental", "accuracy", "accurate_throughput", "koosh",
                      "osf", "kw3", "cgnr_cost", "cgnr_series", "stream_wall"),
    "degrid_radial2d": ("accuracy", "degrid", "osf", "cgnr_cost", "cgnr_series"),
}
BENCH_TOL = {                         # the bench's NRMSEs and their limits
    "nrmse_incremental_vs_direct": INC_TOL,
    "nrmse_accurate_vs_fp32": 1e-3,   # BASELINE.md's gate for --precision accurate
    "nrmse_bf16_vs_fp32": 2e-2,       # bf16 vs fp32 (tests/test_grid_pallas.py:71)
    "nrmse_fp32_vs_jax_golden": 2e-4,  # degrid vs gather (tests/test_degrid_pallas.py:44)
}


T_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line of a phase, with the seconds since the script started."""
    print(f"[{phase}] {msg} (+{time.perf_counter() - T_START:.0f} s)", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device visible; chip_smoke.py runs on a GPU", file=sys.stderr)
        return 1
    if not os.path.isfile(os.path.join(ROOT, "tron_tpu_torch", "csrc", "grid_radial2d.cu")):
        print("error: tron_tpu_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    from tron_tpu_torch import _build
    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.kernels.kb import kb_beta
    from tron_tpu_torch.ops import grid_cuda
    from tron_tpu_torch import recon as recon_mod
    from tron_tpu_torch import solver as solver_mod
    from tron_tpu_torch.nufft import _adjoint_epilogue, sdc_weights
    from tron_tpu_torch.ops.grid import grid_radial2d as grid_dense
    from tron_tpu_torch.ops.grid import grid_radial2d_planes_plain
    from tron_tpu_torch.recon import (
        recon_frames,
        recon_frames_incremental,
        recon_radial2d,
    )
    from tron_tpu_torch.tools.roofline import (  # the least time the card could take
        BF16_TC_FLOPS,
        FP32_FLOPS,
        HBM_BYTES_PER_S,
        TF32_TC_FLOPS,
        bound,
        degrid_bound,
        grid_bound,
    )
    from tron_tpu_torch.tracing import SPANS
    from tron_tpu_torch.trajectory import spoke_angles

    def nrmse(a, b) -> float:
        a = torch.as_tensor(a)
        b = torch.as_tensor(b)
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    # -- 1 env ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log("env", f"nvidia-smi: {smi}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}; tf32 off")

    # -- 2 build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.load()
    # per kernel (source file and kernel, the shared passes once per
    # source): the register range over its instantiations, the whole-body
    # channel block (12) and the instantiations that spill, from ptxas's -v
    # lines; an instantiation is named by its channel block KP (/V/MAXOFF, the
    # degrid kernel's floats per lane and the neighbours per axis it holds: 8
    # for kw < 4, 14 beyond), its precision class, and I/L (integer radii or
    # the exact lattice) with +r where pass 1 rounds the weights as torch does
    fam, name = {}, None
    kernel_re = re.compile(
        r"_(grid_radial2d|grid_radial2d_batched|grid_seg_radial2d|degrid_radial2d)_cu_\w*?"
        r"(grid_tile_(?:band|items|contract|mma|reduce)_kernel|grid_seg_(?:list|contract)_kernel"
        r"|degrid_radial2d_kernel)(I(?:L[ib]\d+E)+E)?")
    for ln in built.log.splitlines():
        m = kernel_re.search(ln)
        if "Compiling entry function" in ln and m:
            args = re.findall(r"L([ib])(\d+)E", m.group(3) or "")
            ints = [v for t, v in args if t == "i"]
            flags = [v for t, v in args if t == "b"]
            key = f"{m.group(1)}.cu:{m.group(2)}"
            inst = (ints[0] if ints else "") + (
                "/" + "/".join(ints[1:3]) if key.startswith("degrid") else "")
            if re.search(r"contract|mma|degrid", key):  # the class is the last int
                inst += " " + CLASSES[int(ints[-1])]
            inst += "".join("L" if f == "1" else "I" for f in flags[:1]) + (
                "+r" if flags[1:] == ["1"] else "") or ("" if inst else "-")
            name = (key, inst)
        elif name and "spill stores" in ln:
            sp = re.search(r"(\d+) bytes spill stores", ln)
            if sp and int(sp.group(1)):
                fam.setdefault(name[0], {"regs": {}, "spills": []})["spills"].append(name[1])
        elif name and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            fam.setdefault(name[0], {"regs": {}, "spills": []})["regs"][name[1]] = int(regs.group(1))
            name = None
    how = f"nvcc {' '.join(_build.NVCC_FLAGS)}, one per source" if built.log else "reused, same sources"
    log("build", f"{built.path.relative_to(ROOT)} from tron_tpu_torch/csrc/ "
        f"({how}) in {time.perf_counter() - t0:.2f} s")
    for key, f in sorted(fam.items()):
        r = f["regs"]
        log("build", f"ptxas {key}: {len(r)} instantiations, {min(r.values())}-{max(r.values())} "
            f"registers (12 channels: {', '.join(f'{k} {v}' for k, v in r.items() if k[:2] == '12')}); "
            f"spills in {sorted(f['spills']) or 'none'}")
    # what the built code holds: B5's contraction runs on tensor cores (HMMA,
    # from mma.sync), B4's contraction stages by bulk async copies (UBLKCP,
    # from cp.async.bulk) on mbarriers (SYNCS)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(built.path)], capture_output=True, text=True,
                          check=True).stdout
    ops, hmma, fn = {}, {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : \S*?(grid_tile_(?:band|items|contract|mma|reduce)_kernel"
                      r"|grid_seg_(?:list|contract)_kernel)(\S*)", ln)
        if "Function :" in ln:
            fn = m.group(1) if m else None
            tmpl = re.findall(r"Li(\d+)E", m.group(2)) if m else []
            mma_cls = CLASSES[int(tmpl[1])] if fn == "grid_tile_mma_kernel" else None
        elif fn:
            for op in ("HMMA", "UBLKCP", "SYNCS", "LDGSTS", "FFMA"):
                if re.search(rf"\b{op}\b", ln):
                    ops.setdefault(fn, set()).add(op)
            if mma_cls:  # B5's MMAs by class: HMMA.1688.F32.BF16 or .TF32
                hmma.setdefault(mma_cls, set()).update(re.findall(r"HMMA\.[\w.]+", ln))
    log("build", "SASS opcodes per gridding kernel: "
        f"{ {k: sorted(v) for k, v in sorted(ops.items())} }")
    require("HMMA" in ops.get("grid_tile_mma_kernel", ()),
            "B5's contraction (grid_tile_mma_kernel) holds no tensor-core MMA (HMMA)")
    log("build", f"B5's MMAs by class: { {k: sorted(v) for k, v in sorted(hmma.items())} }")
    for c in CLASSES:
        want = "TF32" if c == "float32" else "BF16"
        require(any(want in op for op in hmma.get(c, ())),
                f"B5's {c} contraction holds no {want} HMMA: {sorted(hmma.get(c, ()))}")
    require({"UBLKCP", "SYNCS"} <= ops.get("grid_seg_contract_kernel", set()),
            "B4's contraction (grid_seg_contract_kernel) holds no bulk copy (UBLKCP) on an mbarrier")
    # the C++ .ra helper (g++ on first use): its whole-file write and the
    # float16 conversion against the Python path and numpy
    from tron_tpu_torch.io import native as ra_native
    from tron_tpu_torch.io import ra as ra_py

    t0 = time.perf_counter()
    ra_lib = ra_native.ensure_native()
    ra_build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        a = np.random.default_rng(SEED).standard_normal((6, 1, 64, 40, 1)).astype(np.complex64)
        ra_native.ra_write(a, os.path.join(tmp, "n.ra"))
        ra_py.ra_write(a, os.path.join(tmp, "p.ra"))
        with open(os.path.join(tmp, "n.ra"), "rb") as f1, open(os.path.join(tmp, "p.ra"), "rb") as f2:
            same_bytes = f1.read() == f2.read()
        read_back = np.array_equal(ra_native.ra_read(os.path.join(tmp, "p.ra")), a)
    h = np.array([0.0, -0.0, 1.0 + 2.0**-11, 65520.0, 2.0**-25, 3 * 2.0**-25, np.inf, np.nan,
                  1e-3], np.float32)
    with np.errstate(over="ignore"):  # 65520 rounds to inf, as it should
        f16_ok = np.array_equal(ra_native.f32_to_f16(h).view(np.uint16),
                                h.astype(np.float16).view(np.uint16))
    log("build", f".ra helper {os.path.relpath(ra_lib._name, ROOT)} (g++ {' '.join(ra_native.CXX_FLAGS)}) "
        f"in {ra_build_s:.2f} s; write bytes equal to the Python path {same_bytes}, read back "
        f"{read_back}, f32_to_f16 equal to numpy on ties, subnormals, overflow, inf, NaN {f16_ok}")
    require(same_bytes and read_back and f16_ok, "the .ra helper disagrees with the Python path")

    # -- 3 kernel vs plain ---------------------------------------------------
    rng = np.random.default_rng(SEED)
    kw = 2.0
    beta = kb_beta(kw, 2.0)

    def planes_case(nxos, C, npe, skip, signed=False):
        p = rng.standard_normal((npe, nxos, 2 * C), dtype=np.float32)
        planes = torch.from_numpy(p).to(dev)
        ang = spoke_angles(npe, "golden", skip, device=dev)
        if signed:  # an incremental delta: leaving spokes negated
            half = npe // 2
            planes[:half] *= -1
            ang = torch.cat([spoke_angles(half, "golden", skip, device=dev),
                             spoke_angles(npe - half, "golden", skip + 204, device=dev)])
        return planes, ang

    cases = [
        ("nxos64 C1 npe8", 64, 1, 8, 5, False),
        ("nxos128 C2 npe12", 128, 2, 12, 5, False),
        ("nxos256 C2 npe48", 256, 2, 48, 9000, False),
        ("nxos512 C6 npe204", 512, 6, 204, 19000, False),
        ("nxos512 C6 delta42 signed", 512, 6, 42, 19950, True),
        ("nxos128 C10 npe1500 (2 channel blocks, 2 spoke chunks)", 128, 10, 1500, 0, False),
        # the shapes a sharded recon gives the kernel: a coil shard of 2 (3
        # coils, 6 planes) and of 6 (1 coil, 2 planes), a spoke shard of 2 and
        # of 4 (102 and 51 spokes), both at once, a coil shard's 42-spoke delta
        ("nxos512 C3 npe204 (coil shard of 2)", 512, 3, 204, 19000, False),
        ("nxos512 C1 npe204 (coil shard of 6)", 512, 1, 204, 19000, False),
        ("nxos512 C6 npe102 (spoke shard of 2)", 512, 6, 102, 19000, False),
        ("nxos512 C6 npe51 (spoke shard of 4)", 512, 6, 51, 19000, False),
        ("nxos512 C3 npe102 (spoke x coil shard)", 512, 3, 102, 19102, False),
        ("nxos512 C3 delta42 signed (coil shard)", 512, 3, 42, 19950, True),
        ("nxos512 C1 npe51 (spoke shard of 4, coil shard of 6)", 512, 1, 51, 19153, False),
    ]
    err512 = err128 = None
    for name, nxos, C, npe, skip, signed in cases:
        planes, ang = planes_case(nxos, C, npe, skip, signed)
        got = grid_cuda.grid_radial2d_planes(planes, ang, nxos, kw, beta)
        want = grid_radial2d_planes_plain(planes, ang, nxos, kw, beta)
        torch.cuda.synchronize()
        e = nrmse(got, want)
        mae = float((got - want).abs().max())
        log("kernel", f"{name}: nrmse {e:.3e} max_abs_err {mae:.3e} (tol {KERNEL_TOL})")
        require(e <= KERNEL_TOL, f"kernel vs plain {name}: nrmse {e:.3e} > {KERNEL_TOL}")
        if name.startswith("nxos128 C2"):
            err128 = mae
        if name.startswith("nxos512 C6 npe204"):
            err512 = mae
            again = grid_cuda.grid_radial2d_planes(planes, ang, nxos, kw, beta)
            require(torch.equal(got, again), "repeat kernel run is not bitwise equal")
            log("kernel", "nxos512 C6 npe204: repeat run bitwise equal")
    # the complex entry, through to_sample_planes on the card
    d = torch.from_numpy(
        (rng.standard_normal((2, 12, 128)) + 1j * rng.standard_normal((2, 12, 128)))
        .astype(np.complex64)).to(dev)
    ang = spoke_angles(12, "golden", 5, device=dev)
    e = nrmse(grid_cuda.grid_radial2d(d, ang, 128, kw, beta), grid_dense(d, ang, 128, kw, beta))
    log("kernel", f"complex entry nxos128 C2 vs dense gridder: nrmse {e:.3e}")
    require(e <= KERNEL_TOL, f"complex entry nrmse {e:.3e}")

    # -- 4 main path at full width -------------------------------------------
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=SLIDE, adjoint=True)
    work = cfg.npe1work(NRO, 10**9)
    npe1 = work + (NZ - 1) * SLIDE
    require(cfg.frame_geometry(NRO, npe1) == (204, SLIDE, NZ), "whole-body geometry")
    t0 = time.perf_counter()
    host = rng.standard_normal((NC, npe1, NRO), dtype=np.float32) + 1j * rng.standard_normal(
        (NC, npe1, NRO), dtype=np.float32)
    host = host.astype(np.complex64)
    indata = np.transpose(host, (0, 2, 1))[:, None]          # (nc, nt, nro, npe1)
    log("main", f"synthesized ({NC}, 1, {NRO}, {npe1}) complex64 in "
        f"{time.perf_counter() - t0:.1f} s; {NZ} frames of {work} spokes")

    launches = 0
    outs = {}
    for mode in ("direct", "incremental"):
        c = dataclasses.replace(cfg, incremental=mode == "incremental")
        grid_cuda.reset_launches()
        t0 = time.perf_counter()
        out = recon_radial2d(indata, c, device=dev)
        wall = time.perf_counter() - t0
        n_launch = grid_cuda.LAUNCHES
        launches += n_launch
        log("main", f"recon_radial2d {mode}: out {out.shape} {out.dtype}, "
            f"kernel launches {n_launch}, host wall {wall:.3f} s (incl. transfers)")
        require(out.shape == (NZ, 1, NRO // 2, NRO // 2), f"{mode} shape {out.shape}")
        require(bool(np.isfinite(out).all()), f"{mode} output not finite")
        require(n_launch == NZ and grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == NZ,
                f"{mode}: {grid_cuda.LAUNCH_COUNTS} kernel launches, expected {NZ} of the tile kernel")
        outs[mode] = out[:, 0]
    a = torch.from_numpy(outs["direct"]).reshape(NZ, -1)
    b = torch.from_numpy(outs["incremental"]).reshape(NZ, -1)
    worst = float((torch.linalg.vector_norm(b - a, dim=1) / torch.linalg.vector_norm(a, dim=1)).max())
    log("main", f"incremental vs direct worst-frame nrmse {worst:.3e} (tol {INC_TOL})")
    require(worst < INC_TOL, f"incremental vs direct {worst:.3e}")
    # frames 0-2 against the plain version at the same class (the planes
    # gridder at bfloat16, then the recon's own epilogue), and against the
    # plain float32 recon for the class's own error
    d3 = torch.from_numpy(np.ascontiguousarray(host[:, : work + 2 * SLIDE])).to(dev)
    require(cfg.matmul_dtype == "bfloat16", f"the default class is {cfg.matmul_dtype}")

    def plain_frames(data, c, nfr, slide):
        """recon_frames' direct path with the plain planes gridder at c's class."""
        nro = data.shape[-1]
        nxos = int(nro // 2 * c.gridos)
        b = kb_beta(c.kernwidth, c.gridos)
        planes = grid_cuda.to_sample_planes(
            data * sdc_weights(c, nro, work, data.device).to(data.dtype), nxos)
        imgs = []
        for z in range(nfr):
            ang = spoke_angles(work, "golden", c.skip_angles + z * slide, device=dev)
            kg = grid_radial2d_planes_plain(planes[z * slide: z * slide + work], ang, nxos,
                                            c.kernwidth, b, matmul_dtype=c.matmul_dtype)
            imgs.append(recon_mod._combine(_adjoint_epilogue(kg, nro // 2, c, b), c, None))
        return torch.stack(imgs)

    plain3 = plain_frames(d3, cfg, 3, SLIDE)
    plain3_f32 = recon_frames(d3, dataclasses.replace(cfg, backend="jnp"), work, SLIDE, 3)
    for z in range(3):
        e = nrmse(outs["direct"][z], plain3[z].cpu())
        e32 = nrmse(outs["direct"][z], plain3_f32[z].cpu())
        own = nrmse(plain3[z], plain3_f32[z])
        log("main", f"frame {z} kernel recon vs the plain version at bfloat16 on the card: nrmse "
            f"{e:.3e} (tol {KERNEL_TOL}); vs the plain float32 recon {e32:.3e} (the plain "
            f"version's own {own:.3e})")
        require(e <= KERNEL_TOL, f"frame {z} vs plain at bfloat16 {e:.3e}")
        require(0.5 * own <= e32 <= 2 * own, f"frame {z}: class error {e32:.3e}, plain's {own:.3e}")

    # -- 5 golden ------------------------------------------------------------
    g = np.load(os.path.join(ROOT, "tests", "data", "torch_port_golden.npz"))
    grng = np.random.default_rng(int(g["seed"]))
    shape = tuple(int(s) for s in g["shape"])
    gin = (grng.standard_normal(shape) + 1j * grng.standard_normal(shape)).astype(np.complex64)
    gcfg = ReconConfig(golden_angle=True, data_undersamp=float(g["undersamp"]),
                       prof_slide=int(g["slide"]), adjoint=True, matmul_dtype="float32")
    gout = recon_radial2d(gin, gcfg, device=dev)[:, 0]
    e = nrmse(np.abs(gout), g["images"])
    log("golden", f"kernel recon vs JAX golden {g['images'].shape}: nrmse {e:.3e} (tol 1e-5)")
    require(e <= 1e-5, f"golden nrmse {e:.3e}")

    # -- 6 cli ---------------------------------------------------------------
    from tron_tpu_torch import cli
    from tron_tpu_torch.io import ra_read, ra_write

    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "in.ra"), os.path.join(tmp, "out.ra")
        ra_write(np.ascontiguousarray(indata[..., :1479])[..., None], fin)
        rc = cli.main(["-a", "-G", "-u", "0.4", "-d", "21", "-g", "0", fin, fout])
        require(rc == 0, f"cli exit {rc}")
        res = ra_read(fout)
        log("cli", f"tron-torch -a -G -u 0.4 -d 21 on (6, 1, 512, 1479, 1): out dims {res.shape}")
        require(res.shape == (1, 1, 256, 256, 61), f"cli dims {res.shape}")
        require(bool(np.isfinite(res).all()), "cli output not finite")

    # -- 7 timing ------------------------------------------------------------
    dfull = torch.from_numpy(host).to(dev)
    samples = NZ * NC * NRO * work

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps / 1e3  # seconds per call

    rates = {}
    for mode, fn in (("direct", recon_frames), ("incremental", recon_frames_incremental)):
        s = timed(lambda: fn(dfull, cfg, work, SLIDE, NZ), 3)
        rates[mode] = samples / s / 1e6
        log("timing", f"{mode}: {NZ} frames in {s:.4f} s = {rates[mode]:.1f} Msamples/s "
            f"(nz*nc*nro*work / s) on {card}")
    planes, ang = planes_case(512, 6, 204, 19000)
    dplanes, dang = planes_case(512, 6, 42, 19950, signed=True)
    kern = lambda: grid_cuda.grid_radial2d_planes(planes, ang, 512, kw, beta)  # noqa: E731
    plain = lambda: grid_radial2d_planes_plain(planes, ang, 512, kw, beta)  # noqa: E731
    t_plain = [timed(plain, 5)]
    t_kern = [timed(kern, 50), timed(kern, 50)]
    t_plain.append(timed(plain, 5))
    kern_ms = 1e3 * sum(t_kern) / 2
    plain_ms = 1e3 * sum(t_plain) / 2
    delta_ms = 1e3 * timed(
        lambda: grid_cuda.grid_radial2d_planes(dplanes, dang, 512, kw, beta), 50)
    log("timing", f"gridding one whole-body frame (nxos 512, 6 coils, 204 spokes): kernel "
        f"{kern_ms:.4f} ms, plain {plain_ms:.4f} ms; 42-spoke delta kernel {delta_ms:.4f} ms "
        f"(plain,kernel,kernel,plain: {[round(1e3 * t, 4) for t in t_plain[:1] + t_kern + t_plain[1:]]}) "
        f"on {card}")

    grid_pass = re.compile(r"grid_(?:tile|seg)_\w+?_kernel")
    # under a profiler the port's spans (`tracing.SPANS`) are ranges the
    # trace mirrors on the device's timeline: not a kernel, not busy time

    def device_passes(fn, n=20, rx=grid_pass, expect=1):
        """Device us per call of each kernel that ``fn`` launches whose name
        matches ``rx`` (by default the gridding passes), from the profiler
        over n calls.  A profile that holds fewer than ``expect`` such
        kernels is taken again, up to three times in all: the card's
        profiler has lost the device kernels of a whole session (PERF.md
        §7); the callers still require every kernel."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for attempt in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            got = {rx.search(e.key).group(0): e.self_device_time_total / n
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and rx.search(e.key)
                   and e.key not in SPANS}
            if len(got) >= expect:
                break
            log("profiler", f"session {attempt + 1} saw {sorted(got)} of {expect} kernels; again")
        return got

    # the tile kernel's four passes (band and weight table, items, contract,
    # reduce), device time per frame from the profiler
    passes = device_passes(kern, expect=4)
    kern_dev_ms = sum(passes.values()) / 1e3
    log("timing", f"whole-body tile kernel {kern_ms:.4f} ms per frame (PERF.md: the per-pixel "
        f"kernel it replaced took 0.7191 ms); device us per pass: "
        f"{ {k: round(v, 2) for k, v in passes.items()} }, sum {sum(passes.values()):.2f} us")
    require(len(passes) == 4, f"profiler saw the tile kernel's passes {sorted(passes)}")

    # -- 8 degrid kernel vs plain ---------------------------------------------
    from tron_tpu_torch.ops import degrid_cuda
    from tron_tpu_torch.ops.degrid import degrid_radial2d as degrid_plain
    from tron_tpu_torch.ops.degrid import lattice_radii, wrap_edge_readouts

    def cgrid(*shape):
        a = rng.standard_normal(shape, dtype=np.float32) + 1j * rng.standard_normal(
            shape, dtype=np.float32)
        return torch.from_numpy(a.astype(np.complex64)).to(dev)

    dcases = [  # name, nxos, coils, spokes, nro, gridos
        ("nxos64 C1", 64, 1, 8, 64, 2.0),
        ("nxos128 C2", 128, 2, 12, 128, 2.0),
        ("nxos256 C6", 256, 6, 48, 256, 2.0),
        ("nxos512 C6 npe204", 512, 6, 204, 512, 2.0),
        ("nxos128 C10 (2 channel blocks)", 128, 10, 30, 128, 2.0),
        ("gridos1.5 nxos384 nro512 C2", 384, 2, 24, 512, 1.5),
        ("gridos2.5 nxos640 nro512 C2", 640, 2, 24, 512, 2.5),
        ("odd nro255 nxos256 C2", 256, 2, 12, 255, 2.0),
        # a sharded recon's shapes: coil shards of 2 and of 6, spoke shards of 2 and of 4
        ("nxos512 C3 npe204 (coil shard of 2)", 512, 3, 204, 512, 2.0),
        ("nxos512 C1 npe204 (coil shard of 6)", 512, 1, 204, 512, 2.0),
        ("nxos512 C6 npe102 (spoke shard of 2)", 512, 6, 102, 512, 2.0),
        ("nxos512 C6 npe51 (spoke shard of 4)", 512, 6, 51, 512, 2.0),
        ("nxos512 C3 npe102 (spoke x coil shard)", 512, 3, 102, 512, 2.0),
    ]
    derr512 = None
    for name, n, C, npe, nro, gos in dcases:
        b = kb_beta(kw, gos)
        g = cgrid(C, n, n)
        ang = spoke_angles(npe, "golden", 19000, device=dev)
        for wrap in (True, False):
            got = degrid_cuda.degrid_radial2d(g, ang, nro, kw, b, wrap=wrap)
            again = degrid_cuda.degrid_radial2d(g, ang, nro, kw, b, wrap=wrap)
            want = degrid_plain(g, ang, nro, kw, b, wrap=wrap)
            torch.cuda.synchronize()
            e = nrmse(got, want)
            mae = float((got - want).abs().max())
            same = torch.equal(got, again)
            log("degrid", f"{name} {'wrap' if wrap else 'clip'}: nrmse {e:.3e} "
                f"max_abs_err {mae:.3e} (tol {KERNEL_TOL}); repeat run bitwise equal: {same}")
            require(e <= KERNEL_TOL, f"degrid vs plain {name} wrap={wrap}: nrmse {e:.3e}")
            require(same, f"repeat degrid run is not bitwise equal: {name} wrap={wrap}")
            if name == "nxos512 C6 npe204" and not wrap:
                derr512 = mae

    # kernel widths beyond the narrow instantiation's 8 neighbours per axis.
    # The KB window is not normalised (the deapodisation divides it out): a
    # weight product reaches (I0(beta) / 2kw)^2, 8e21 at kw 6.5, so the grids
    # are scaled by its inverse to keep the float32 norms finite
    def kb_unit(kww, b):
        return (2 * kww / float(np.i0(b))) ** 2

    derr_wide = {}
    for kww in (4.0, 6.5):
        b = kb_beta(kww, 2.0)
        for name, n, C, npe, nro in (("nxos256 C6", 256, 6, 48, 256),
                                     ("nxos512 C6 npe204", 512, 6, 204, 512),
                                     ("nxos128 C10 odd nro127", 128, 10, 30, 127)):
            g = cgrid(C, n, n) * kb_unit(kww, b)
            ang = spoke_angles(npe, "golden", 19000, device=dev)
            for wrap in (True, False):
                got = degrid_cuda.degrid_radial2d(g, ang, nro, kww, b, wrap=wrap)
                again = degrid_cuda.degrid_radial2d(g, ang, nro, kww, b, wrap=wrap)
                want = degrid_plain(g, ang, nro, kww, b, wrap=wrap)
                torch.cuda.synchronize()
                e = nrmse(got, want)
                same = torch.equal(got, again)
                mae = float((got - want).abs().max())
                log("degrid", f"kw {kww} ({int(2 * kww) + 1} neighbours per axis) {name} "
                    f"{'wrap' if wrap else 'clip'}: nrmse {e:.3e} max_abs_err {mae:.3e} of max "
                    f"{float(want.abs().max()):.3e} (tol {KERNEL_TOL}); repeat run bitwise equal: {same}")
                require(bool(torch.isfinite(want).all()) and float(want.abs().max()) > 0,
                        f"degrid kw {kww} {name}: the plain version is not finite and nonzero")
                require(e <= KERNEL_TOL, f"degrid vs plain kw {kww} {name} wrap={wrap}: {e:.3e}")
                require(same, f"repeat degrid run is not bitwise equal: kw {kww} {name}")
                derr_wide[kww] = mae
            del g, got, again, want

    # the wrap-edge rule (ops/degrid.fp32_wrap_edges): under wrap at bf16x2
    # and bf16x3 the readouts JAX's patch recomputes at float32 are the
    # float32 kernel's, bit for bit, from a second launch; every other readout
    # is the class kernel's (the first launch alone, as the wrapper makes it)
    def class_launch(g, ang, nro, c):
        return degrid_cuda._launch(degrid_cuda.to_grid_planes(g), torch.cos(ang), torch.sin(ang),
                                   lattice_radii(nro, g.shape[-1], dev), kw, beta, True, c)

    for name, n, C, npe in (("nxos512 C6 npe204", 512, 6, 204), ("nxos256 C6", 256, 6, 48)):
        g = cgrid(C, n, n)
        ang = spoke_angles(npe, "golden", 19000, device=dev)
        idx = wrap_edge_readouts(n, n, kw).to(dev)
        keep = torch.ones(n, dtype=torch.bool, device=dev)
        keep[idx] = False
        f32 = degrid_cuda.degrid_radial2d(g, ang, n, kw, beta)
        for c in ("bf16x2", "bf16x3"):
            before = degrid_cuda.LAUNCHES
            got = degrid_cuda.degrid_radial2d(g, ang, n, kw, beta, matmul_dtype=c)
            two = degrid_cuda.LAUNCHES - before
            again = degrid_cuda.degrid_radial2d(g, ang, n, kw, beta, matmul_dtype=c)
            cls = class_launch(g, ang, n, c)
            want = degrid_plain(g, ang, n, kw, beta, wrap=True, matmul_dtype=c)
            torch.cuda.synchronize()
            edges = torch.equal(got[..., idx], f32[..., idx])
            inner = torch.equal(got[..., keep], cls[..., keep])
            e, e_cls = nrmse(got, want), nrmse(got[..., idx], cls[..., idx])
            log("degrid", f"{name} wrap {c}: {len(idx)} wrap-edge readouts a spoke bitwise the "
                f"float32 kernel's: {edges}, the rest bitwise the class kernel's: {inner}, "
                f"launches {two}; vs the plain version at {c} nrmse {e:.3e} (tol {KERNEL_TOL}); "
                f"the edges vs the class kernel's {e_cls:.3e}; repeat bitwise {torch.equal(got, again)}")
            require(edges and inner, f"degrid wrap edges {name} {c}: edges {edges}, rest {inner}")
            require(two == 2, f"degrid wrap {name} {c}: {two} launches, expected 2")
            require(e <= KERNEL_TOL, f"degrid wrap {name} {c} vs plain: nrmse {e:.3e}")
            require(torch.equal(got, again), f"repeat degrid run is not bitwise equal: {name} {c}")
        del g, got, again, cls, want, f32

    # -- 9 exact lattice -----------------------------------------------------
    for gos in (1.5, 2.0, 2.5):
        nxos = int(256 * gos)
        b = kb_beta(kw, gos)
        d = cgrid(2, 48, 512)
        ang = spoke_angles(48, "golden", 7, device=dev)
        got = grid_cuda.grid_radial2d_exact(d, ang, nxos, kw, b)
        d0 = d.clone()
        d0[..., 0] = 0  # readout 0 is never gridded; the dense oracle would grid it
        e = nrmse(got, grid_dense(d0, ang, nxos, kw, b, raw_rows=True))
        log("exact", f"gridos {gos} (nro 512, nxos {nxos}, C2, npe48) kernel vs plain raw rows: "
            f"nrmse {e:.3e} (tol {KERNEL_TOL})")
        require(e <= KERNEL_TOL, f"exact lattice gridos {gos}: nrmse {e:.3e}")
        if gos == 2.0:
            e = nrmse(got, grid_cuda.grid_radial2d(d, ang, nxos, kw, b))
            log("exact", f"gridos 2 row lattice vs integer radii: nrmse {e:.3e} (tol 1e-6)")
            require(e <= 1e-6, f"row lattice vs integer path {e:.3e}")

    # -- 10 dot test of the kernel pair -----------------------------------------
    for gos in (1.5, 2.0, 2.5):
        nxos = int(256 * gos)
        b = kb_beta(kw, gos)
        npe = 24
        x = cgrid(2, nxos, nxos)
        y = cgrid(2, npe, 512)
        y[..., 0] = 0
        ang = spoke_angles(npe, "golden", 2, device=dev)
        Ax = degrid_cuda.degrid_radial2d(x, ang, 512, kw, b, wrap=False)
        if nxos == 512:
            AHy = grid_cuda.grid_radial2d(y, ang, nxos, kw, b)
        else:
            AHy = grid_cuda.grid_radial2d_exact(y, ang, nxos, kw, b)
        AHy = AHy * (nxos * npe)  # undo the gridder's 1/(nxos*npe)
        lhs = complex(torch.vdot(y.reshape(-1), Ax.reshape(-1)))
        rhs = complex(torch.vdot(AHy.reshape(-1), x.reshape(-1)))
        rel = abs(lhs - rhs) / abs(rhs)
        log("dot", f"gridos {gos}: |<y,Ax> - <A^H y,x>| / |<A^H y,x>| = {rel:.3e} (tol {DOT_TOL})")
        require(rel < DOT_TOL, f"dot test gridos {gos}: {rel:.3e}")

    for kww in (4.0, 6.5):
        b = kb_beta(kww, 2.0)
        npe = 24
        x = cgrid(2, 512, 512) * kb_unit(kww, b)
        y = cgrid(2, npe, 512)
        y[..., 0] = 0
        ang = spoke_angles(npe, "golden", 2, device=dev)
        Ax = degrid_cuda.degrid_radial2d(x, ang, 512, kww, b, wrap=False)
        AHy = grid_cuda.grid_radial2d(y, ang, 512, kww, b) * (512 * npe)
        lhs = complex(torch.vdot(y.reshape(-1), Ax.reshape(-1)))
        rhs = complex(torch.vdot(AHy.reshape(-1), x.reshape(-1)))
        rel = abs(lhs - rhs) / abs(rhs)
        log("dot", f"kw {kww}, gridos 2: |<y,Ax> - <A^H y,x>| / |<A^H y,x>| = {rel:.3e} "
            f"(tol {DOT_TOL})")
        require(rel < DOT_TOL, f"dot test kw {kww}: {rel:.3e}")

    # -- 11 forward main path ------------------------------------------------
    from tron_tpu_torch.nufft import nufft_adjoint, nufft_forward

    n_img = NRO // 2
    fimgs = (rng.standard_normal((NC, 1, n_img, n_img, NF), dtype=np.float32)
             + 1j * rng.standard_normal((NC, 1, n_img, n_img, NF), dtype=np.float32)
             ).astype(np.complex64)
    fcfg = ReconConfig(golden_angle=True, data_undersamp=1.0, matmul_dtype="float32")
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    t0 = time.perf_counter()
    fout = recon_radial2d(fimgs, fcfg, device=dev)
    wall = time.perf_counter() - t0
    fwd_launches = degrid_cuda.LAUNCHES
    log("forward", f"recon_radial2d -G -u 1 on ({NC}, 1, {n_img}, {n_img}, {NF}): out "
        f"{fout.shape} {fout.dtype}, degrid launches {fwd_launches}, grid launches "
        f"{grid_cuda.LAUNCHES}, host wall {wall:.3f} s (incl. transfers)")
    require(fout.shape == (NF, NC, 1, NRO, NRO), f"forward shape {fout.shape}")
    require(bool(np.isfinite(fout).all()), "forward output not finite")
    require(fwd_launches == NF and grid_cuda.LAUNCHES == 0,
            f"forward: {fwd_launches} degrid launches, expected {NF}")
    fd = torch.from_numpy(np.ascontiguousarray(
        np.transpose(fimgs, (4, 0, 1, 3, 2)).reshape(NF, NC, n_img, n_img))).to(dev)
    fang = spoke_angles(NRO, "golden", 0, device=dev)
    plain0 = nufft_forward(fd[0], fang, dataclasses.replace(fcfg, backend="jnp"), nro=NRO)
    e = nrmse(fout[0].reshape(NC, NRO, NRO), plain0.cpu())
    log("forward", f"frame 0 kernel forward vs plain forward on the card: nrmse {e:.3e} "
        f"(tol {KERNEL_TOL})")
    require(e <= KERNEL_TOL, f"forward frame 0 vs plain {e:.3e}")

    # the same forward at bf16x3 (`tron-torch --precision accurate`): two
    # degrid launches a frame, the class's and the wrap edges' at float32
    from tron_tpu_torch.ops.fftops import centered_fft2, deapodize, pad_center

    fcfg3 = dataclasses.replace(fcfg, matmul_dtype="bf16x3")
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    t0 = time.perf_counter()
    fout3 = recon_radial2d(fimgs, fcfg3, device=dev)
    wall = time.perf_counter() - t0
    fwd3_launches = degrid_cuda.LAUNCHES
    fidx = wrap_edge_readouts(NRO, NRO, kw).numpy()
    fedges = np.array_equal(fout3[..., fidx], fout[..., fidx])
    kg0 = centered_fft2(deapodize(pad_center(fd[0], NRO), NRO, kw, beta))
    plain3 = degrid_plain(kg0, fang, NRO, kw, beta, wrap=True, matmul_dtype="bf16x3")
    e = nrmse(fout3[0].reshape(NC, NRO, NRO), plain3.cpu())
    e32 = nrmse(fout3, fout)
    log("forward", f"recon_radial2d -G -u 1 at bf16x3: out {fout3.shape}, degrid launches "
        f"{fwd3_launches}, grid launches {grid_cuda.LAUNCHES}, host wall {wall:.3f} s; the "
        f"{len(fidx)} wrap-edge readouts a spoke bitwise the float32 forward's: {fedges}; frame 0 "
        f"vs the plain version at bf16x3 nrmse {e:.3e} (tol {KERNEL_TOL}); vs float32 {e32:.3e}")
    require(fwd3_launches == 2 * NF and grid_cuda.LAUNCHES == 0,
            f"forward at bf16x3: {fwd3_launches} degrid launches, expected {2 * NF}")
    require(fedges and bool(np.isfinite(fout3).all()), "forward at bf16x3: wrap edges not float32's")
    require(e <= KERNEL_TOL, f"forward frame 0 at bf16x3 vs plain {e:.3e}")
    del fout3, plain3, kg0

    # -- 12 CGNR main path ---------------------------------------------------
    ccfg = dataclasses.replace(cfg, niter=NITER, matmul_dtype="float32")
    probe = np.ascontiguousarray(indata[..., : work + 7 * SLIDE])
    t0 = time.perf_counter()
    recon_radial2d(probe, ccfg, device=dev)
    per_frame = (time.perf_counter() - t0) / 8
    nzc = NZ if per_frame * NZ <= CG_WALL else 128
    why = ("the whole series" if nzc == NZ else
           f"the first 128 frames: the series would take {per_frame * NZ:.0f} s > {CG_WALL:.0f} s")
    log("cgnr", f"8-frame probe {per_frame * 1e3:.1f} ms per frame; running {why}")
    cin = indata if nzc == NZ else np.ascontiguousarray(indata[..., : work + (nzc - 1) * SLIDE])
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    solver_mod.reset_cgnr_prologue_counts()
    t0 = time.perf_counter()
    cout = recon_radial2d(cin, ccfg, device=dev)
    wall = time.perf_counter() - t0
    cg_grid, cg_degrid = grid_cuda.LAUNCHES, degrid_cuda.LAUNCHES
    require(solver_mod.CGNR_PROLOGUE_COUNTS == {"replayed": nzc, "eager": 0},
            f"cgnr: prologues {solver_mod.CGNR_PROLOGUE_COUNTS}, expected {nzc} replayed "
            "(the probe captured the geometry)")
    log("cgnr", f"recon_radial2d -a -G -u 0.4 -d {SLIDE} -i {NITER}: out {cout.shape}, grid "
        f"launches {cg_grid} ({cg_grid / nzc:g} per frame), degrid launches {cg_degrid} "
        f"({cg_degrid / nzc:g} per frame), host wall {wall:.2f} s (incl. transfers)")
    require(cout.shape == (nzc, 1, n_img, n_img), f"cgnr shape {cout.shape}")
    require(bool(np.isfinite(cout).all()), "cgnr output not finite")
    require(cg_grid == nzc * (NITER + 1) and cg_degrid == nzc * NITER,
            f"cgnr launches grid {cg_grid} degrid {cg_degrid}, expected "
            f"{nzc * (NITER + 1)} and {nzc * NITER}")
    d2 = torch.from_numpy(np.ascontiguousarray(host[:, : work + SLIDE])).to(dev)
    plain2 = recon_frames(d2, dataclasses.replace(ccfg, backend="jnp"), work, SLIDE, 2)
    for z in range(2):
        e = nrmse(cout[z, 0], plain2[z].cpu())
        log("cgnr", f"frame {z} kernel CGNR vs plain-operator CGNR (pair) on the card: "
            f"nrmse {e:.3e} (tol {CG_TOL})")
        require(e <= CG_TOL, f"cgnr frame {z} vs plain {e:.3e}")
    tcfg = dataclasses.replace(ccfg, toeplitz=True)
    grid_cuda.reset_launches()
    degrid_cuda.reset_launches()
    solver_mod.reset_toeplitz_counts()
    solver_mod.reset_cgnr_prologue_counts()
    tout = recon_radial2d(probe, tcfg, device=dev)
    psf_counts = dict(solver_mod.TOEPLITZ_COUNTS)
    require(solver_mod.CGNR_PROLOGUE_COUNTS == {"replayed": 7, "eager": 1},
            f"toeplitz: prologues {solver_mod.CGNR_PROLOGUE_COUNTS}, expected the first frame's "
            "eager and 7 replayed")
    log("cgnr", f"--toeplitz on 8 frames: out {tout.shape}, grid launches "
        f"{grid_cuda.LAUNCHES}, degrid launches {degrid_cuda.LAUNCHES}, multipliers built "
        f"{psf_counts}; vs pair-mode CGNR "
        f"frames 0-7: nrmse {nrmse(tout[:, 0], cout[:8, 0]):.3e} (NUFFT-level, not a bound)")
    require(tout.shape == (8, 1, n_img, n_img), f"toeplitz shape {tout.shape}")
    require(bool(np.isfinite(tout).all()), "toeplitz output not finite")
    require(grid_cuda.LAUNCHES == 16 and degrid_cuda.LAUNCHES == 0,
            "toeplitz: expected 2 grid launches (kernel, right side) per frame, no degrid")
    require(psf_counts == {"nufft": 8, "exact": 0},
            f"toeplitz: multipliers built {psf_counts}, expected one gridded a frame, no exact")

    # -- 13 solver sanity on the phantom -------------------------------------
    from tron_tpu_torch.metrics import lmse
    from tron_tpu_torch.phantom import birdcage_sensitivities, shepp_logan
    from tron_tpu_torch.solver import cgnr_radial2d

    ph = birdcage_sensitivities(n_img, NC) * shepp_logan(n_img)[None]
    pimg = torch.from_numpy(ph).to(dev)
    scfg = ReconConfig(golden_angle=True, matmul_dtype="float32")
    sang = spoke_angles(work, "golden", 0, device=dev)
    pdata = nufft_forward(pimg, sang, scfg)
    e_adj = lmse(nufft_adjoint(pdata, sang, scfg).cpu().numpy(), ph)
    prev = np.inf
    for it in (1, 4, 12):
        xcg = cgnr_radial2d(pdata, sang, scfg, niter=it)
        resid = float(torch.linalg.vector_norm(nufft_forward(xcg, sang, scfg) - pdata))
        e_cg = lmse(xcg.cpu().numpy(), ph)
        log("solver", f"6-coil birdcage Shepp-Logan {n_img}^2, {work} spokes: -i {it} data "
            f"residual {resid:.4e}, lmse {e_cg:.4e} (adjoint {e_adj:.4e})")
        require(resid < prev * 1.01, f"residual rose at -i {it}")
        prev = resid
    require(e_cg < e_adj, f"CGNR lmse {e_cg:.4e} does not beat the adjoint's {e_adj:.4e}")

    # -- 14 cli, forward and CGNR --------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        fimg, fdat = os.path.join(tmp, "img.ra"), os.path.join(tmp, "data.ra")
        ra_write(np.ascontiguousarray(fimgs[:, :, :64, :64, :2]), fimg)
        rc = cli.main(["-G", "-g", "0", fimg, fdat])
        require(rc == 0, f"cli forward exit {rc}")
        res = ra_read(fdat)
        log("cli2", f"tron-torch -G on ({NC}, 1, 64, 64, 2): out dims {res.shape}")
        require(res.shape == (NC, 1, 128, 128, 2), f"cli forward dims {res.shape}")
        require(bool(np.isfinite(res).all()), "cli forward output not finite")
        fin, fout2 = os.path.join(tmp, "in.ra"), os.path.join(tmp, "cg.ra")
        ra_write(np.ascontiguousarray(indata[..., : work + 3 * SLIDE])[..., None], fin)
        rc = cli.main(["-a", "-G", "-u", "0.4", "-d", str(SLIDE), "-i", "4", "-g", "0", fin, fout2])
        require(rc == 0, f"cli -i 4 exit {rc}")
        res = ra_read(fout2)
        log("cli2", f"tron-torch -a -G -u 0.4 -d {SLIDE} -i 4 on ({NC}, 1, {NRO}, {work + 3 * SLIDE}, 1): "
            f"out dims {res.shape}")
        require(res.shape == (1, 1, n_img, n_img, 4), f"cli -i dims {res.shape}")
        require(bool(np.isfinite(res).all()), "cli -i output not finite")

    # -- 15 timing: degrid, forward, CGNR ------------------------------------
    kg = cgrid(NC, NRO, NRO)
    dang = spoke_angles(work, "golden", 19000, device=dev)
    dkern = lambda: degrid_cuda.degrid_radial2d(kg, dang, NRO, kw, beta, wrap=False)  # noqa: E731
    dplain = lambda: degrid_plain(kg, dang, NRO, kw, beta, wrap=False)  # noqa: E731
    td_plain = [timed(dplain, 5)]
    td_kern = [timed(dkern, 50), timed(dkern, 50)]
    td_plain.append(timed(dplain, 5))
    dkern_ms = 1e3 * sum(td_kern) / 2
    dplain_ms = 1e3 * sum(td_plain) / 2
    # the kernel alone: the bare C call on ready grid planes, without the
    # wrapper's relayout (to_grid_planes), cos/sin, radius table and output
    # allocation
    kgp = degrid_cuda.to_grid_planes(kg)
    dct, dst = torch.cos(dang), torch.sin(dang)
    drad = lattice_radii(NRO, NRO, dev)
    dout = torch.empty((NC, work, NRO), dtype=torch.complex64, device=dev)

    def dbare():
        code = built.lib.tron_degrid_radial2d_planes(
            kgp.data_ptr(), dct.data_ptr(), dst.data_ptr(), drad.data_ptr(), dout.data_ptr(),
            work, NRO, NRO, 2 * NC, int(2 * kw) + 1, 0, kw, beta, CLASSES.index("float32"),
            torch.cuda.current_stream().cuda_stream)
        _build.check(built.lib, code, "degrid_radial2d kernel")

    td_bare = [timed(dbare, 200), timed(dbare, 200)]
    dbare_ms = 1e3 * sum(td_bare) / 2
    require(torch.equal(dout, dkern()), "the bare degrid call differs from the wrapper's")
    log("timing2", f"degridding one CGNR frame ({NC}x{NRO}x{NRO} -> {NC}x{work}x{NRO}, clip): wrapper "
        f"{dkern_ms:.4f} ms, kernel alone {dbare_ms:.4f} ms, plain {dplain_ms:.4f} ms "
        f"(plain,wrapper,wrapper,plain: "
        f"{[round(1e3 * t, 4) for t in td_plain[:1] + td_kern + td_plain[1:]]}; kernel alone "
        f"{[round(1e3 * t, 4) for t in td_bare]}) on {card}")

    def forward_all():
        for z in range(NF):
            nufft_forward(fd[z], fang, fcfg, nro=NRO)

    s = timed(forward_all, 3)
    log("timing2", f"forward: {NF} frames in {s:.4f} s = {NF * NC * NRO * NRO / s / 1e6:.1f} "
        f"Msamples/s (nz*nc*npe1*nro / s) on {card}")

    # at bf16x3, with and without the wrap-edge launch (without it: the class
    # launch alone, the route before the rule), in 10 pairs whose order
    # alternates; B3 per call the same way at bf16x2 and bf16x3 on a CGNR
    # frame's geometry under wrap, and the edge launch alone
    def no_edges(fn):
        def run():
            rule = degrid_cuda.fp32_wrap_edges
            degrid_cuda.fp32_wrap_edges = lambda *a: False
            try:
                fn()
            finally:
                degrid_cuda.fp32_wrap_edges = rule
        return run

    def pairs(fn, reps, n=10):
        """Medians and interquartile ranges (s per call) of n pairs, without
        and with the edge launch, and how many pairs the edge launch lost."""
        t = {"without": [], "with": []}
        for i in range(n):
            order = (("without", no_edges(fn)), ("with", fn))
            for k, f in order if i % 2 == 0 else order[::-1]:
                t[k].append(timed(f, reps))
        q = {k: np.percentile(v, [25, 50, 75]) for k, v in t.items()}
        lost = sum(b > a for a, b in zip(t["without"], t["with"]))
        return {k: float(v[1]) for k, v in q.items()}, {k: float(v[2] - v[0]) for k, v in q.items()}, lost

    def forward3_all():
        for z in range(NF):
            nufft_forward(fd[z], fang, fcfg3, nro=NRO)

    med, iqr, lost = pairs(forward3_all, 3)
    samples3 = NF * NC * NRO * NRO
    fwd3_rate = {k: samples3 / v / 1e6 for k, v in med.items()}
    log("timing2", f"forward at bf16x3, {NF} frames, 10 pairs: median {fwd3_rate['without']:.1f} "
        f"Msamples/s without the wrap-edge launch ({1e3 * med['without']:.4f} ms, IQR "
        f"{1e3 * iqr['without']:.4f}), {fwd3_rate['with']:.1f} with it ({1e3 * med['with']:.4f} ms, "
        f"IQR {1e3 * iqr['with']:.4f}); the edge launch slower in {lost} of 10 pairs on {card}")
    b3_edge_ms = {}
    for c in ("bf16x2", "bf16x3"):
        med, iqr, lost = pairs(lambda c=c: degrid_cuda.degrid_radial2d(kg, dang, NRO, kw, beta,
                                                                        matmul_dtype=c), 50)
        b3_edge_ms[c] = {k: 1e3 * v for k, v in med.items()}
        log("timing2", f"B3 wrapper at {c}, wrap ({NC}x{NRO}x{NRO} -> {NC}x{work}x{NRO}), 10 pairs: "
            f"median {1e3 * med['without']:.4f} ms without the wrap-edge launch (IQR "
            f"{1e3 * iqr['without']:.4f}), {1e3 * med['with']:.4f} ms with it (IQR "
            f"{1e3 * iqr['with']:.4f}); slower in {lost} of 10 pairs on {card}")
    eidx, erad = degrid_cuda._edge_tables(NRO, NRO, kw, dev)
    b3_edge_ms["edge_launch"] = 1e3 * timed(lambda: degrid_cuda._launch(
        kgp, dct, dst, erad, kw, beta, True, "float32"), 200)
    log("timing2", f"the wrap-edge launch alone ({len(eidx)} readouts a spoke, float32, on ready "
        f"grid planes): {b3_edge_ms['edge_launch']:.4f} ms on {card}")
    nzt = min(32, NZ)
    dcg = dfull[:, : work + (nzt - 1) * SLIDE]
    s = timed(lambda: recon_frames(dcg, ccfg, work, SLIDE, nzt), 1)
    log("timing2", f"CGNR -i {NITER}: {1e3 * s / nzt:.3f} ms per frame ({nzt} frames, one "
        f"replay of the iteration's CUDA graph an iteration) on {card}")

    # -- 16 seg: the segmented gridding kernel (windowed=False, B4) ----------
    from tron_tpu_torch.config import KernelTuning
    from tron_tpu_torch.ops.grid import grid_radial2d_planes_culled

    seg_cases = [  # name, nxos, coils, spokes, angle scheme, nro of an exact lattice
        ("nxos64 C1 npe8 golden", 64, 1, 8, "golden", None),
        ("nxos128 C2 npe12 linear_half", 128, 2, 12, "linear_half", None),
        ("nxos256 C2 npe48 golden, lattice nro 256", 256, 2, 48, "golden", 256),
        ("nxos384 C3 npe30 linear_half", 384, 3, 30, "linear_half", None),
        ("nxos384 C3 npe30 golden, lattice nro 512 (gridos 1.5)", 384, 3, 30, "golden", 512),
        ("nxos512 C6 npe204 golden", 512, 6, 204, "golden", None),
        ("nxos512 C6 npe204 golden, lattice nro 512", 512, 6, 204, "golden", 512),
        ("nxos512 C3 npe204 golden (coil shard of 2)", 512, 3, 204, "golden", None),
        ("nxos512 C1 npe102 golden (coil shard of 6, spoke shard of 2)", 512, 1, 102, "golden", None),
        ("nxos512 C3 npe51 golden, lattice nro 512 (sharded CGNR's adjoint)", 512, 3, 51, "golden", 512),
        ("nxos640 C2 npe24 linear_half, lattice nro 512 (gridos 2.5)", 640, 2, 24, "linear_half", 512),
        ("nxos100 C3 npe17 golden (partial edge tiles)", 100, 3, 17, "golden", None),
        ("nxos128 C10 npe1500 golden (2 channel blocks, 6 spoke chunks)", 128, 10, 1500, "golden", None),
        ("nxos40 C2 npe12 golden (20-row segments)", 40, 2, 12, "golden", None),
        ("nxos36 C2 npe11 golden, lattice nro 27 (odd, 13-row segments)", 36, 2, 11, "golden", 27),
        ("nxos8 C1 npe5 golden, lattice nro 6 (3-row segments, 42 per stage)", 8, 1, 5, "golden", 6),
    ]
    bt = KernelTuning(batched=True)

    def three_checks(phase, name, planes, sang, nxos, kwc, bc, rad):
        """B4 (seg) within SEG_TOL of the tile kernel (B1): B1's fp32 terms,
        regrouped at work items; B1, B4 and B5 (batched) each within
        KERNEL_TOL of its plain version (the culled planes gridder for B4;
        for B1 and B5 the planes gridder, at the row radii on a lattice);
        each repeat run bitwise equal (no atomics)."""
        runs = {}
        for k, windowed, tuning in (("tile", True, None), ("seg", False, None), ("batched", True, bt)):
            runs[k] = [grid_cuda._launch(planes, sang, nxos, kwc, bc, rad, windowed, tuning)
                       for _ in range(2)]
        culled = grid_radial2d_planes_culled(planes, sang, nxos, kwc, bc, rad=rad)
        plain = culled if rad is not None else grid_radial2d_planes_plain(planes, sang, nxos, kwc, bc)
        torch.cuda.synchronize()
        tile, seg, bat = (runs[k][0] for k in ("tile", "seg", "batched"))
        rep = {k: torch.equal(*v) for k, v in runs.items()}
        e41 = nrmse(seg, tile)
        errs = {"tile": nrmse(tile, plain), "seg": nrmse(seg, culled), "batched": nrmse(bat, plain)}
        log(phase, f"{name}: seg vs tile nrmse {e41:.3e} (tol {SEG_TOL}); vs plain nrmse "
            f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol {KERNEL_TOL}); repeat "
            f"bitwise {rep}")
        for k, same in rep.items():
            require(same, f"repeat {k}-kernel run is not bitwise equal: {name}")
        require(e41 <= SEG_TOL, f"seg vs tile kernel {name}: nrmse {e41:.3e}")
        for k, v in errs.items():
            require(v <= KERNEL_TOL, f"{k} kernel vs plain {name}: nrmse {v:.3e}")
        return float((seg - culled).abs().max())

    seg_err = None
    for name, nxos, C, npe, scheme, nro in seg_cases:
        d = cgrid(C, npe, nro or nxos)
        d[:, : npe // 2] *= -1  # signed, as an incremental delta
        sang = spoke_angles(npe, scheme, 19000 if scheme == "golden" else 0, device=dev)
        if nro is None:
            mae = three_checks("seg", name, grid_cuda.to_sample_planes(d, nxos), sang, nxos, kw,
                               beta, None)
        else:
            mae = three_checks("seg", name, grid_cuda._planes(d), sang, nxos, kw, beta,
                               lattice_radii(nro, nxos, dev))
        if name == "nxos512 C6 npe204 golden":
            seg_err = mae
    wb_planes, wb_ang = planes_case(512, 6, 204, 19000)
    d42_planes, d42_ang = planes_case(512, 6, 42, 19950, signed=True)
    tilek = lambda: grid_cuda.grid_radial2d_planes(wb_planes, wb_ang, 512, kw, beta)  # noqa: E731
    segk = lambda: grid_cuda.grid_radial2d_planes(  # noqa: E731
        wb_planes, wb_ang, 512, kw, beta, windowed=False)
    cplain = lambda: grid_radial2d_planes_culled(wb_planes, wb_ang, 512, kw, beta)  # noqa: E731
    ts = [timed(cplain, 1), timed(tilek, 50), timed(segk, 50), timed(segk, 50), timed(tilek, 50),
          timed(cplain, 1)]
    seg_ms = 1e3 * (ts[2] + ts[3]) / 2
    seg_plain_ms = 1e3 * (ts[0] + ts[5]) / 2
    seg_delta_ms = 1e3 * timed(lambda: grid_cuda.grid_radial2d_planes(
        d42_planes, d42_ang, 512, kw, beta, windowed=False), 50)
    seg_passes = device_passes(segk, expect=4)
    seg_dev_ms = sum(seg_passes.values()) / 1e3
    log("seg", f"one whole-body frame (nxos 512, 6 coils, 204 spokes): seg kernel {seg_ms:.4f} ms, tile "
        f"kernel {1e3 * (ts[1] + ts[4]) / 2:.4f} ms, culled plain {seg_plain_ms:.4f} ms "
        f"(plain, tile, seg, seg, tile, plain: {[round(1e3 * t, 4) for t in ts]}); 42-spoke delta "
        f"seg kernel {seg_delta_ms:.4f} ms; device us per pass: "
        f"{ {k: round(v, 2) for k, v in seg_passes.items()} }, sum {1e3 * seg_dev_ms:.2f} us "
        f"(PERF.md: the per-pixel kernel it replaced took 0.6798 ms) on {card}")
    require(len(seg_passes) == 4, f"profiler saw the seg kernel's passes {sorted(seg_passes)}")

    # -- 17 batched: the tensor-core gridding kernel (tuning.batched, B5) -----
    for kwb in (1.5, 2.0, 3.0):
        bb = kb_beta(kwb, 2.0)
        for lname, nxos, nro in (("integer radii, nxos 512", 512, None),
                                 ("lattice nro 512, nxos 384 (gridos 1.5)", 384, 512),
                                 ("lattice nro 512, nxos 640 (gridos 2.5)", 640, 512)):
            name = f"kw {kwb} {lname}, 6 coils, 204 spokes"
            if nro is None:
                three_checks("batched", name, wb_planes, wb_ang, nxos, kwb, bb, None)
            else:
                three_checks("batched", name, grid_cuda._planes(cgrid(6, 204, nro)), wb_ang, nxos,
                             kwb, bb, lattice_radii(nro, nxos, dev))
    bat = grid_cuda.grid_radial2d_planes(wb_planes, wb_ang, 512, kw, beta, tuning=bt)
    want = grid_radial2d_planes_plain(wb_planes, wb_ang, 512, kw, beta)
    bat_err = float((bat - want).abs().max())
    e = nrmse(bat, want)
    log("batched", f"whole-body frame vs plain: nrmse {e:.3e} max_abs_err {bat_err:.3e}")
    require(e <= KERNEL_TOL, f"batched vs plain nrmse {e:.3e}")
    batk = lambda: grid_cuda.grid_radial2d_planes(  # noqa: E731
        wb_planes, wb_ang, 512, kw, beta, tuning=bt)
    wplain = lambda: grid_radial2d_planes_plain(wb_planes, wb_ang, 512, kw, beta)  # noqa: E731
    tb = [timed(wplain, 5), timed(tilek, 50), timed(batk, 50), timed(batk, 50), timed(tilek, 50),
          timed(wplain, 5)]
    bat_ms = 1e3 * (tb[2] + tb[3]) / 2
    bat_plain_ms = 1e3 * (tb[0] + tb[5]) / 2
    bat_delta_ms = 1e3 * timed(lambda: grid_cuda.grid_radial2d_planes(
        d42_planes, d42_ang, 512, kw, beta, tuning=bt), 50)
    bat_passes = device_passes(batk, expect=4)
    bat_dev_ms = sum(bat_passes.values()) / 1e3
    log("batched", f"one whole-body frame: batched kernel {bat_ms:.4f} ms, tile kernel "
        f"{1e3 * (tb[1] + tb[4]) / 2:.4f} ms, plain {bat_plain_ms:.4f} ms (plain, tile, batched, "
        f"batched, tile, plain: {[round(1e3 * t, 4) for t in tb]}); 42-spoke delta batched kernel "
        f"{bat_delta_ms:.4f} ms; device us per pass: "
        f"{ {k: round(v, 2) for k, v in bat_passes.items()} }, sum {1e3 * bat_dev_ms:.2f} us "
        f"(PERF.md: the per-pixel kernel it replaced took 0.8377 ms) on {card}")
    require(len(bat_passes) == 4, f"profiler saw the batched kernel's passes {sorted(bat_passes)}")

    # -- 18 stream: tron-torch --stream on the whole-body series --------------
    half_ref = recon_radial2d(indata, cfg, half_readback=True, device=dev)[:, 0]
    blocks = -(-NZ // 64)
    stream_b1 = stream_b5 = 0
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "wholebody.ra"), os.path.join(tmp, "out.ra")
        t0 = time.perf_counter()
        ra_write(indata[..., None], fin)
        log("stream", f"wrote the whole-body series ({NC}, 1, {NRO}, {npe1}, 1) complex64, "
            f"{os.path.getsize(fin) / 1e6:.1f} MB, in {time.perf_counter() - t0:.2f} s")
        first = None
        for name, extra, env in (
            ("--stream", [], {}),
            ("--stream, again", [], {}),
            ("--stream --incremental", ["--incremental"], {}),
            ("--stream --half", ["--half"], {}),
            ("TRON_BATCHED=1 --stream", [], {"TRON_BATCHED": "1"}),
        ):
            os.environ.update(env)
            grid_cuda.reset_launches()
            io_calls = dict(ra_native.CALLS)
            t0 = time.perf_counter()
            try:
                rc = cli.main(["-a", "-G", "-u", "0.4", "-d", str(SLIDE), "--stream", "-g", "0",
                               *extra, fin, fout])
            finally:
                for k in env:
                    os.environ.pop(k)
            wall = time.perf_counter() - t0
            counts = dict(grid_cuda.LAUNCH_COUNTS)
            io_calls = {k: ra_native.CALLS[k] - v for k, v in io_calls.items()}
            require(rc == 0, f"{name}: exit {rc}")
            require(all(io_calls.values()), f"{name}: the .ra helper was not used: {io_calls}")
            res = ra_read(fout)
            if "--half" in extra:
                require(res.shape == (2, 1, 1, n_img, n_img, NZ) and res.dtype == np.float16,
                        f"{name}: {res.shape} {res.dtype}")
                hre = np.ascontiguousarray(res[0, 0, 0].transpose(2, 1, 0))
                him = np.ascontiguousarray(res[1, 0, 0].transpose(2, 1, 0))
                same = (np.array_equal(hre, half_ref.real.astype(np.float16))
                        and np.array_equal(him, half_ref.imag.astype(np.float16)))
                e = nrmse(hre.astype(np.float32) + 1j * him.astype(np.float32), half_ref)
                what = "in-memory --half readback"
            else:
                require(res.shape == (1, 1, n_img, n_img, NZ) and res.dtype == np.complex64,
                        f"{name}: {res.shape} {res.dtype}")
                frames = np.ascontiguousarray(res[0, 0].transpose(2, 1, 0))
                require(bool(np.isfinite(frames).all()), f"{name}: output not finite")
                e = nrmse(frames, outs["direct"])
                same = np.array_equal(frames, outs["direct"])
                what = "in-memory direct recon"
                if first is None:
                    first = frames
                elif name == "--stream, again":
                    require(np.array_equal(frames, first), "repeat --stream run is not bitwise equal")
                if "--incremental" in extra:
                    worst = max(nrmse(frames[z], outs["direct"][z]) for z in range(NZ))
                    what += (f" (worst frame {worst:.3e}; vs in-memory incremental "
                             f"{nrmse(frames, outs['incremental']):.3e})")
            kernel = "grid_radial2d_batched" if env else "grid_radial2d"
            log("stream", f"tron-torch -a -G -u 0.4 -d {SLIDE} {name}: file to file "
                f"{wall:.3f} s host wall = {NZ * NC * NRO * work / wall / 1e6:.1f} Msamples/s; launches "
                f"{counts}; .ra helper calls {io_calls}; vs {what}: nrmse {e:.3e}, bitwise equal "
                f"{same} on {card}")
            require(e <= 1e-5, f"{name}: nrmse {e:.3e} vs {what}")
            require(counts[kernel] == blocks * 64 and grid_cuda.LAUNCHES == counts[kernel],
                    f"{name}: launches {counts}, expected {blocks * 64} of {kernel}")
            if env:
                stream_b5 += counts[kernel]
            else:
                stream_b1 += counts[kernel]
            os.remove(fout)

        # where the streamed wall goes: each stage alone, then the card's busy
        # share over one profiled --stream run (the page cache holds the file)
        from tron_tpu_torch.io.native import ra_read_profiles

        bf, z0s = 64, [min(z0, NZ - 64) for z0 in range(0, NZ, 64)]
        nblk = work + (bf - 1) * SLIDE
        pinned = torch.empty((1, NC, nblk, NRO), dtype=torch.complex64, pin_memory=True)
        t0 = time.perf_counter()
        for z0 in z0s:
            pinned.numpy()[...] = ra_read_profiles(fin, z0 * SLIDE, nblk).transpose(1, 0, 3, 2)
        t_load = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bouts = [recon_frames(dfull[:, z0 * SLIDE: z0 * SLIDE + nblk], cfg, work, SLIDE, bf, z0 * SLIDE)
                 for z0 in z0s]
        t_disp = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        hosts = [o.cpu().numpy() for o in bouts]
        t_d2h = time.perf_counter() - t0
        del bouts, hosts
        # the read stage alone through the .ra helper and through Python
        # seeks and reads, in turns (page cache warm): a record, no claim
        t_read = {}
        for nat in (True, False, False, True):
            t0 = time.perf_counter()
            wins = [ra_read_profiles(fin, z0 * SLIDE, nblk, native=nat) for z0 in z0s]
            t_read.setdefault(nat, []).append(time.perf_counter() - t0)
            if nat:
                win_native = wins
            else:
                require(all(np.array_equal(u, v) for u, v in zip(win_native, wins)),
                        "windowed reads: the helper and Python differ")
            del wins
        del win_native
        log("stream", f"read stage alone ({len(z0s)} windows of {nblk} spokes, "
            f"{len(z0s) * nblk * NC * NRO * 8 / 1e6:.0f} MB): .ra helper "
            f"{[round(t, 4) for t in t_read[True]]} s, Python {[round(t, 4) for t in t_read[False]]} s "
            f"(helper, Python, Python, helper), the same arrays, on {card}")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            rc = cli.main(["-a", "-G", "-u", "0.4", "-d", str(SLIDE), "--stream", "-g", "0", fin, fout])
            wall = time.perf_counter() - t0
        require(rc == 0, f"profiled --stream: exit {rc}")
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in SPANS]
        busy = sum(e.self_device_time_total for e in ka) / 1e6
        # every gridding kernel's passes: grid_tile_* (B1, B5, and the items
        # and reduce passes of B4) and grid_seg_* (B4)
        gridding = re.compile(r"grid_(?:tile|seg)_\w+?_kernel")
        grid_s = sum(e.self_device_time_total for e in ka if gridding.search(e.key)) / 1e6
        log("stream", f"alone: loader (read {len(z0s)} blocks of {nblk} spokes, transpose into pinned) "
            f"{t_load:.3f} s; frames on device-resident data {t_comp:.3f} s (dispatch {t_disp:.3f} s); "
            f"D2H {t_d2h:.3f} s. Profiled --stream: wall {wall:.3f} s, card busy {busy:.3f} s "
            f"({100 * busy / wall:.1f} %, kernels summed over streams), gridding kernel {grid_s:.3f} s "
            f"({100 * grid_s / busy:.1f} % of busy) on {card}")

    # -- 19 kbench: the port's kernel bench ------------------------------------
    from tron_tpu_torch.tools import kbench

    kb = {}
    for name, argv, kernel in (("default", [], "grid_radial2d"),
                               ("--no-windowed", ["--no-windowed"], "grid_seg_radial2d"),
                               ("--batched", ["--batched"], "grid_radial2d_batched"),
                               ("--op degrid", ["--op", "degrid"], "degrid_radial2d"),
                               ("--dtype float32", ["--dtype", "float32"], "grid_radial2d"),
                               ("--batched --dtype float32", ["--batched", "--dtype", "float32"],
                                "grid_radial2d_batched")):
        r = kbench.main([*argv, "--check"])
        kb[name] = r
        log("kbench", f"python -m tron_tpu_torch.tools.kbench {name} --check: kernel {r['kernel']}, "
            f"{r['ms_per_frame']:.4f} ms/frame, {r['msamples_per_s']:.1f} Msamples/s, nrmse vs plain "
            f"{r['nrmse_vs_plain']:.3e} on {card}")
        require(r["kernel"] == kernel, f"kbench {name} ran {r['kernel']}, expected {kernel}")
        require(r["nrmse_vs_plain"] <= KERNEL_TOL, f"kbench {name}: nrmse {r['nrmse_vs_plain']:.3e}")
        # where a kbench frame's device time goes: every kernel of one pass
        # over its frames in the profiler, the gridding passes apart
        kfn, _, _ = kbench.make_case(kbench.build_parser().parse_args(argv), dev)
        nf = r["frames"]
        frame = itertools.cycle(range(nf))
        per = device_passes(lambda: kfn(next(frame)), n=nf, rx=re.compile(r".+"))
        busy_us = sum(per.values())
        grid_us = sum(v for k, v in per.items() if grid_pass.search(k))
        top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
        log("kbench", f"{name}: card busy {busy_us:.2f} us per frame of {1e3 * r['ms_per_frame']:.2f} "
            f"us ({100 * busy_us / (1e3 * r['ms_per_frame']):.1f} %), gridding passes {grid_us:.2f} "
            f"us, {len(per)} kernels; most: { {k[:48]: round(v, 2) for k, v in top} } on {card}")
        del kfn

    # -- 31 precision: the four classes in every kernel, at whole-body width --
    # (run here, after 19: late in this process, after the phases that open
    # many profiler runs, the profiler lost device kernels of some calls)
    from tron_tpu_torch.ops.precision import bf16

    t31 = time.perf_counter()
    passes_of = {"bfloat16": 1, "bf16x2": 2, "bf16x3": 3, "float32": 1}
    deg_pass = re.compile(r"degrid_radial2d_kernel")
    wb_dplanes = cgrid(NC, 512, 512)
    kw4, b4 = 4.0, kb_beta(4.0, 2.0)
    wb_dplanes4 = wb_dplanes * kb_unit(kw4, b4)
    b2_planes, b2_ang = planes_case(128, 2, 12, 5)

    def grid_case(planes, ang, nxos, **kw_):
        """(kernel at a class, plain at a class) of one gridding kernel."""
        windowed = kw_.get("windowed", True)

        def kern(c):
            return grid_cuda.grid_radial2d_planes(planes, ang, nxos, kw, beta, matmul_dtype=c, **kw_)

        def plain(c):
            cc, rounded = grid_cuda.gridder_class(nxos, c, windowed)
            p = bf16(planes) if rounded else planes
            if not windowed:
                return grid_radial2d_planes_culled(p, ang, nxos, kw, beta, matmul_dtype=cc)
            return grid_radial2d_planes_plain(p, ang, nxos, kw, beta, matmul_dtype=cc)

        return kern, plain

    def degrid_case(g, kww, bb):
        return (lambda c: degrid_cuda.degrid_radial2d(g, dang, NRO, kww, bb, matmul_dtype=c,
                                                      wrap=False),
                lambda c: degrid_plain(g, dang, NRO, kww, bb, wrap=False, matmul_dtype=c))

    prec_cases = {  # kernel row -> (kernel, plain, pass names, bound of one call's work)
        "grid_radial2d": (*grid_case(wb_planes, wb_ang, 512), grid_pass,
                          lambda p: grid_bound(wb_planes, wb_ang, 512, p)),
        "grid_radial2d_batched": (*grid_case(wb_planes, wb_ang, 512, tuning=bt), grid_pass,
                                  lambda p: grid_bound(wb_planes, wb_ang, 512, p, BF16_TC_FLOPS)),
        "grid_seg_radial2d": (*grid_case(wb_planes, wb_ang, 512, windowed=False), grid_pass,
                              lambda p: grid_bound(wb_planes, wb_ang, 512, p)),
        "grid_radial2d (nxos 128)": (*grid_case(b2_planes, b2_ang, 128), grid_pass,
                                     lambda p: grid_bound(b2_planes, b2_ang, 128, p)),
        "degrid_radial2d": (*degrid_case(wb_dplanes, kw, beta), deg_pass,
                            lambda p: degrid_bound(wb_dplanes, dang, NRO, p)),
        "degrid_radial2d (kw 4)": (*degrid_case(wb_dplanes4, kw4, b4), deg_pass,
                                   lambda p: degrid_bound(wb_dplanes4, dang, NRO, p, kww=kw4)),
    }
    prec = {}
    for name, (kern_c, plain_c, rx, bound_c) in prec_cases.items():
        outs_c, row = {}, {"err": {}, "err_f32": {}, "own_f32": {}, "ms": {}, "bound_ms": {}}
        ref32 = plain_c("float32")
        for c in CLASSES:
            got, again = kern_c(c), kern_c(c)
            want = plain_c(c)
            torch.cuda.synchronize()
            outs_c[c] = got
            e, e32, own = nrmse(got, want), nrmse(got, ref32), nrmse(want, ref32)
            dev_us = device_passes(lambda: kern_c(c), n=10, rx=rx,
                                   expect=1 if rx is deg_pass else 4)
            require(len(dev_us) == (1 if rx is deg_pass else 4),
                    f"{name} {c}: the profiler saw the passes {sorted(dev_us)}")
            row["err"][c], row["err_f32"][c], row["own_f32"][c] = e, e32, own
            row["ms"][c] = sum(dev_us.values()) / 1e3
            if name == "grid_radial2d_batched" and c == "float32":  # 3xTF32
                row["bound_ms"][c] = grid_bound(wb_planes, wb_ang, 512, 3, TF32_TC_FLOPS)[0]
            else:
                row["bound_ms"][c] = bound_c(passes_of[c])[0]
            log("precision", f"{name} {c}: vs the plain version at {c} nrmse {e:.3e} (tol "
                f"{KERNEL_TOL}); vs the plain float32 {e32:.3e} (the plain version's own "
                f"{own:.3e}); repeat bitwise {torch.equal(got, again)}; device "
                f"{1e3 * row['ms'][c]:.2f} us per call; bound {1e3 * row['bound_ms'][c]:.3f} us "
                f"on {card}")
            require(e <= KERNEL_TOL, f"{name} {c}: kernel vs plain at the class {e:.3e}")
            require(torch.equal(got, again), f"{name} {c}: a repeat run is not bitwise equal")
            if c == "float32":
                require(e32 <= KERNEL_TOL, f"{name} float32: {e32:.3e}")
            elif own > 0:
                require(0.5 * own <= e32 <= 2 * own, f"{name} {c}: the class is not applied "
                        f"(vs float32 {e32:.3e}, the plain version's own {own:.3e})")
        # the classes JAX's dispatch runs as another (grid_pallas.py:735-738, :832-833)
        if name == "grid_radial2d (nxos 128)":
            for c in ("bf16x2", "bf16x3"):
                require(torch.equal(outs_c[c], outs_c["float32"]), f"B2 {c} is not float32")
        if name == "grid_seg_radial2d":
            require(torch.equal(outs_c["bf16x2"], outs_c["bf16x3"]), "B4 bf16x2 is not bf16x3")
        prec[name] = row
        del outs_c, ref32
    log("precision", f"B2's bf16x2 and bf16x3 are its float32 bit for bit, B4's bf16x2 its bf16x3; "
        f"phase 31 in {time.perf_counter() - t31:.1f} s")
    del wb_dplanes, wb_dplanes4

    # B3 where JAX degrids densely in fp32 whatever the class (a grid that
    # does not tile, an odd nro; degrid_pallas.py:319-325): float32 at every
    # class, bit for bit, wrapped and clipped
    for (n_c4, nro_c4) in ((128, 128), (256, 255)):
        g_c4 = cgrid(2, n_c4, n_c4)
        ang_c4 = spoke_angles(12, "golden", 7, device=dev)
        for wrap in (True, False):
            ref_c4 = degrid_cuda.degrid_radial2d(g_c4, ang_c4, nro_c4, kw, beta, wrap=wrap)
            same = all(torch.equal(degrid_cuda.degrid_radial2d(
                g_c4, ang_c4, nro_c4, kw, beta, matmul_dtype=c, wrap=wrap), ref_c4)
                for c in CLASSES)
            e = nrmse(ref_c4, degrid_plain(g_c4, ang_c4, nro_c4, kw, beta, wrap=wrap))
            log("precision", f"B3 at n {n_c4}, nro {nro_c4}, {'wrap' if wrap else 'clip'} (JAX's "
                f"dense fp32 fallback): every class bit for bit its float32 {same}; float32 vs "
                f"the plain version nrmse {e:.3e}")
            require(same and e <= KERNEL_TOL, f"B3 at n {n_c4}, nro {nro_c4}: the class rule")

    # -- 32 library: the kernels' function as one cuSPARSE SpMM ---------------
    # (tools/library_call: the KB interpolation matrix as CSR, int32 indices,
    # built on the card outside the timed window; kernel, library, library,
    # kernel in turns, float32; the library's device time from the profiler)
    from tron_tpu_torch.tools import library_call as libcall

    t32 = time.perf_counter()
    kbp, kbs = degrid_cuda.to_grid_planes(kg), (torch.cos(dang), torch.sin(dang))
    kb_out = torch.empty((NC, work, NRO), dtype=torch.complex64, device=dev)

    def degrid_bare(wrap):
        """The degridding kernel alone (the bare C call) on grid planes, float32."""
        def run():
            code = built.lib.tron_degrid_radial2d_planes(
                kbp.data_ptr(), kbs[0].data_ptr(), kbs[1].data_ptr(), drad.data_ptr(),
                kb_out.data_ptr(), work, NRO, NRO, 2 * NC, int(2 * kw) + 1, int(wrap), kw, beta,
                CLASSES.index("float32"), torch.cuda.current_stream().cuda_stream)
            _build.check(built.lib, code, "degrid_radial2d kernel")
            return kb_out
        return run

    exact_rad = lattice_radii(wb_planes.shape[1], 512, dev)
    lib_cases = {  # row -> (matrix, input planes, relayout, plain, kernel at float32, its passes)
        "grid_radial2d": (
            lambda: libcall.interp_matrix(wb_ang, 512, 512, kw, beta, transpose=True), wb_planes,
            lambda y: libcall.grid_output(y, 512),
            lambda: grid_radial2d_planes_plain(wb_planes, wb_ang, 512, kw, beta),
            lambda: grid_cuda.grid_radial2d_planes(wb_planes, wb_ang, 512, kw, beta), grid_pass),
        "grid_radial2d (exact lattice)": (
            lambda: libcall.interp_matrix(wb_ang, 512, exact_rad, kw, beta, transpose=True),
            wb_planes, lambda y: libcall.grid_output(y, 512),
            lambda: grid_radial2d_planes_culled(wb_planes, wb_ang, 512, kw, beta, rad=exact_rad),
            lambda: grid_cuda._launch(wb_planes, wb_ang, 512, kw, beta, exact_rad, True, None),
            grid_pass),
        "grid_radial2d (nxos 128)": (
            lambda: libcall.interp_matrix(b2_ang, 128, 128, kw, beta, transpose=True), b2_planes,
            lambda y: libcall.grid_output(y, 128),
            lambda: grid_radial2d_planes_plain(b2_planes, b2_ang, 128, kw, beta),
            lambda: grid_cuda.grid_radial2d_planes(b2_planes, b2_ang, 128, kw, beta), grid_pass),
        "degrid_radial2d": (
            lambda: libcall.interp_matrix(dang, NRO, NRO, kw, beta, wrap=False), kbp,
            lambda y: libcall.degrid_output(y, work, NRO),
            lambda: degrid_plain(kg, dang, NRO, kw, beta, wrap=False), degrid_bare(False),
            deg_pass),
        "degrid_radial2d (wrap)": (
            lambda: libcall.interp_matrix(dang, NRO, NRO, kw, beta, wrap=True), kbp,
            lambda y: libcall.degrid_output(y, work, NRO),
            lambda: degrid_plain(kg, dang, NRO, kw, beta, wrap=True), degrid_bare(True),
            deg_pass),
    }
    lib = {}
    for name, (make, x, relayout, plain_f, kern_f, rx) in lib_cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = make()
        torch.cuda.synchronize()
        build_ms = 1e3 * (time.perf_counter() - t0)
        mm = libcall.grid_library if name.startswith("grid") else libcall.degrid_library
        call = lambda: mm(x, A)  # noqa: E731
        y, y2 = call(), call()
        e = nrmse(relayout(y), plain_f())
        ek = nrmse(relayout(y), kern_f())
        repeat = torch.equal(y, y2)
        tl = [timed(kern_f, 200), timed(call, 200), timed(call, 200), timed(kern_f, 200)]
        lib_dev = device_passes(call, n=20, rx=re.compile(r".+"))
        kern_dev = device_passes(kern_f, n=20, rx=rx, expect=1 if rx is deg_pass else 4)
        K = x.shape[-1]
        nnz = A.values().numel()
        l_bound, l_by = bound(libcall.spmm_bytes(A, K), 2.0 * nnz * K)
        try:  # bfloat16 values and operand, where the card's torch takes them
            Ab = torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(),
                                         A.values().to(torch.bfloat16), A.shape,
                                         check_invariants=False)
            xb = x.to(torch.bfloat16)
            yb = mm(xb, Ab)
            bf16_err = nrmse(relayout(yb.float()), plain_f())
            bf16 = {"ms": 1e3 * timed(lambda: mm(xb, Ab), 200), "err_vs_plain_f32": bf16_err}
        except Exception as ex:  # noqa: BLE001 (recorded: which call the card refuses)
            bf16 = f"none: {type(ex).__name__}: {str(ex).splitlines()[0] if str(ex) else ''}"
        lib[name] = {
            "ms": 1e3 * (tl[1] + tl[2]) / 2, "kernel_ms": 1e3 * (tl[0] + tl[3]) / 2,
            "device_ms": sum(lib_dev.values()) / 1e3, "kernel_device_ms": sum(kern_dev.values()) / 1e3,
            "bound_ms": l_bound, "bound_by": l_by, "nnz": nnz, "build_ms": build_ms,
            "index": str(A.col_indices().dtype).replace("torch.", ""),
            "matrix_mb": libcall.matrix_bytes(A) / 1e6,
            "err": e, "repeat_bitwise": repeat, "bf16": bf16,
        }
        log("library", f"{name}: {nnz} nonzeros ({lib[name]['index']} indices, "
            f"{lib[name]['matrix_mb']:.1f} MB, built in {build_ms:.1f} ms); vs the plain version "
            f"nrmse {e:.3e} (tol {KERNEL_TOL}), vs the kernel {ek:.3e}; repeat bitwise {repeat}; "
            f"kernel, library, library, kernel ms {[round(1e3 * t, 4) for t in tl]}; device us: "
            f"library {1e3 * lib[name]['device_ms']:.2f} "
            f"({ {k[:40]: round(v, 2) for k, v in lib_dev.items()} }), kernel "
            f"{1e3 * lib[name]['kernel_device_ms']:.2f}; library bound {1e3 * l_bound:.3f} us "
            f"({l_by}); bfloat16: {bf16} on {card}")
        require(e <= KERNEL_TOL, f"library {name}: {e:.3e} from the plain version")
        require(lib_dev, f"library {name}: the profiler saw no device kernel of the call")
        require(len(kern_dev) == (1 if rx is deg_pass else 4),
                f"library {name}: the profiler saw the kernel's passes {sorted(kern_dev)}")
        del A, y, y2
    for argv in (["--library"], ["--library", "--op", "degrid"]):
        r = kbench.main([*argv, "--check"])
        log("library", f"python -m tron_tpu_torch.tools.kbench {' '.join(argv)} --check: "
            f"{r['ms_per_frame']:.4f} ms/frame ({r['kernel']}), nrmse vs plain "
            f"{r['nrmse_vs_plain']:.3e}, set-up with the frames' matrices {r['library_build_s']:.2f} s "
            f"on {card}")
        require(r["nrmse_vs_plain"] <= KERNEL_TOL and sum(r["launches"].values()) == 0,
                f"kbench {argv}: {r}")
    log("library", f"phase 32 in {time.perf_counter() - t32:.1f} s")

    # -- 20 koosh: the -3 stack of stars at whole-body width -------------------
    from tron_tpu_torch.ops import coil

    NPE2, KNPE1, KNZI = 32, 816, 4

    def kz_slice(stack, b, inverse):
        """Slice b of the centred, unnormalised kz transform along axis 0 of a
        host array, as one weighted sum: sum_k w[k] stack[k] with w[k] =
        exp(+-2 pi i (k - N/2)(b - N/2) / N)."""
        N = stack.shape[0]
        k = np.arange(N) - N // 2
        w = np.exp((2j if inverse else -2j) * np.pi * k * (b - N // 2) / N)
        return np.tensordot(w.astype(np.complex64), stack, axes=1)

    def fresh_counts():
        grid_cuda.reset_launches()
        degrid_cuda.reset_launches()

    def counts_now():
        return dict(grid_cuda.LAUNCH_COUNTS, degrid_radial2d=degrid_cuda.LAUNCHES)

    t0 = time.perf_counter()
    # in disk order (kz slowest, coil fastest): the payload of the .ra of
    # phase 21, viewed as (nc, nt, nro, npe1, npe2)
    kT = np.empty((NPE2, KNPE1, NRO, 1, NC), np.complex64)
    kT.real[...] = rng.standard_normal(kT.shape, dtype=np.float32)
    kT.imag[...] = rng.standard_normal(kT.shape, dtype=np.float32)
    kdata = kT.T
    log("koosh", f"synthesized {kdata.shape} complex64, {kdata.nbytes / 1e6:.0f} MB, in "
        f"{time.perf_counter() - t0:.1f} s")
    kcfg = ReconConfig(golden_angle=True, data_undersamp=0.4, adjoint=True, koosh=True)
    kcfg2 = dataclasses.replace(kcfg, koosh=False, prof_slide=0)
    require(kcfg2.frame_geometry(NRO, KNPE1) == (work, work, KNZI), "stack-of-stars geometry")
    new_counts = {k: 0 for k in (*grid_cuda.KERNELS, "degrid_radial2d")}

    def counted(want: dict, what: str):
        """The launches since fresh_counts() are exactly ``want``; they join
        the main paths' totals."""
        got = {k: v for k, v in counts_now().items() if v}
        require(got == want, f"{what}: launches {got}, expected {want}")
        for k, v in got.items():
            new_counts[k] += v

    kouts = {}
    for half in (False, True):
        fresh_counts()
        t0 = time.perf_counter()
        kouts[half] = recon_radial2d(kdata, kcfg, half_readback=half, device=dev)
        wall = time.perf_counter() - t0
        log("koosh", f"recon_radial2d -3 -a -G -u 0.4{' (float16 readback)' if half else ''}: out "
            f"{kouts[half].shape} {kouts[half].dtype}, launches {counts_now()}, host wall "
            f"{wall:.3f} s (incl. transfers) on {card}")
        counted({"grid_radial2d": NPE2 * KNZI}, "koosh adjoint")
    kout = kouts[False]
    require(kout.shape == (NPE2 * KNZI, 1, n_img, n_img), f"koosh shape {kout.shape}")
    require(bool(np.isfinite(kout).all()), "koosh output not finite")
    e = nrmse(kouts[True], kout)
    log("koosh", f"float16 readback vs complex64 readback: nrmse {e:.3e} (tol 2^-11)")
    require(e <= 2.0**-11, f"koosh half readback {e:.3e}")
    # the kz axis decouples: slice b is the 2-D recon of slice b of the kz
    # transform, taken here on the host; twice through the plain gridder,
    # once through the kernel
    for b, backend in ((0, "jnp"), (17, "jnp"), (31, "auto")):
        slb = torch.from_numpy(np.ascontiguousarray(kz_slice(kT, b, True)[:, :, 0].transpose(2, 0, 1)))
        if backend == "jnp":  # the plain gridder at the -3 path's class
            ref = plain_frames(slb.to(dev), kcfg2, KNZI, work)
        else:
            ref = recon_frames(slb.to(dev), kcfg2, work, work, KNZI)
        e = nrmse(kout[b * KNZI:(b + 1) * KNZI, 0], ref.cpu())
        how = "the plain gridder at bfloat16" if backend == "jnp" else "recon_frames (kernel)"
        log("koosh", f"slice {b}: -3 output vs {how} on the host-side kz transform: nrmse {e:.3e} "
            f"(tol {KERNEL_TOL})")
        require(e <= KERNEL_TOL, f"koosh slice {b} vs {how}: {e:.3e}")
    kd = recon_mod._upload(kdata, dev)
    t_fft = timed(lambda: recon_mod._koosh_kz_ifft(kd), 3)
    ksl = recon_mod._koosh_kz_ifft(kd)
    del kd

    def kblocks():
        for b0 in range(0, NPE2, 8):
            recon_mod._koosh_slice_block(ksl, b0, 8, kcfg2, work, work, KNZI)

    t_blk = timed(kblocks, 2)
    frame2d_ms = NC * NRO * work / (rates["direct"] * 1e3)
    log("koosh", f"adjoint on device-resident data: kz transform {1e3 * t_fft:.3f} ms, "
        f"{NPE2 * KNZI} slice-frames in {1e3 * t_blk:.2f} ms = {1e3 * t_blk / (NPE2 * KNZI):.4f} ms "
        f"per slice-frame (a 2-D direct frame: {frame2d_ms:.4f} ms) = "
        f"{NPE2 * NC * NRO * KNPE1 / t_blk / 1e6:.1f} Msamples/s on {card}")
    del ksl

    kimgs = (rng.standard_normal((NC, 1, n_img, n_img, NPE2), dtype=np.float32)
             + 1j * rng.standard_normal((NC, 1, n_img, n_img, NPE2), dtype=np.float32)
             ).astype(np.complex64)
    kfcfg = ReconConfig(golden_angle=True, data_undersamp=1.0, koosh=True, matmul_dtype="float32")
    fresh_counts()
    t0 = time.perf_counter()
    kfout = recon_radial2d(kimgs, kfcfg, device=dev)
    wall = time.perf_counter() - t0
    log("koosh", f"recon_radial2d -3 -G -u 1 on {kimgs.shape}: out {kfout.shape} {kfout.dtype}, "
        f"launches {counts_now()}, host wall {wall:.3f} s (incl. transfers) on {card}")
    counted({"degrid_radial2d": NPE2}, "koosh forward")
    require(kfout.shape == (NPE2, NC, 1, NRO, NRO), f"koosh forward shape {kfout.shape}")
    require(bool(np.isfinite(kfout).all()), "koosh forward output not finite")
    for z in (0, 21):
        dz = kz_slice(kfout, z, True)[:, 0] / NPE2
        img_z = torch.from_numpy(np.ascontiguousarray(kimgs[:, 0, :, :, z].transpose(0, 2, 1))).to(dev)
        ref = nufft_forward(img_z, fang, dataclasses.replace(fcfg, backend="jnp"), nro=NRO)
        e = nrmse(dz, ref.cpu())
        log("koosh", f"slice {z}: host-side inverse kz transform of the -3 forward vs the plain "
            f"forward: nrmse {e:.3e} (tol {KERNEL_TOL})")
        require(e <= KERNEL_TOL, f"koosh forward slice {z}: {e:.3e}")
    kfd = recon_mod._upload(kimgs, dev).permute(4, 0, 1, 3, 2).reshape(NPE2, NC, n_img, n_img)
    kfcfg2 = dataclasses.replace(kfcfg, koosh=False, prof_slide=0)
    t_kf = timed(lambda: recon_mod._koosh_forward_device(kfd, kfcfg2, NRO, NRO), 2)
    log("koosh", f"forward on device-resident data: {NPE2} slices in {1e3 * t_kf:.2f} ms = "
        f"{1e3 * t_kf / NPE2:.4f} ms per slice = {NPE2 * NC * NRO * NRO / t_kf / 1e6:.1f} Msamples/s "
        f"on {card}")
    del kfd, kfout
    # two repetitions at a smaller depth: 4 kz encodings, 2 in-plane frames;
    # the forward's degridding call then carries 2*nc*nt = 24 real channels
    k2 = cgrid(NC, 2, NRO, 2 * work, 4).cpu().numpy()
    fresh_counts()
    o2 = recon_radial2d(k2, dataclasses.replace(kcfg, matmul_dtype="float32"), device=dev)
    counted({"grid_radial2d": 4 * 2 * 2}, "koosh adjoint nt 2")
    p2 = recon_radial2d(k2, dataclasses.replace(kcfg, backend="jnp"), device=dev)
    e = nrmse(o2, p2)
    log("koosh", f"nt 2, npe2 4: adjoint out {o2.shape} vs the plain gridder: nrmse {e:.3e} "
        f"(tol {KERNEL_TOL})")
    require(o2.shape == (8, 2, n_img, n_img) and e <= KERNEL_TOL, f"koosh nt 2 adjoint {e:.3e}")
    f2 = cgrid(NC, 2, n_img, n_img, 4).cpu().numpy()
    fresh_counts()
    fo2 = recon_radial2d(f2, kfcfg, device=dev)
    counted({"degrid_radial2d": 4}, "koosh forward nt 2")
    fp2 = recon_radial2d(f2, dataclasses.replace(kfcfg, backend="jnp"), device=dev)
    e = nrmse(fo2, fp2)
    log("koosh", f"nt 2, nz 4: forward out {fo2.shape} (24 real channels per degridding call) vs "
        f"the plain degridder: nrmse {e:.3e} (tol {KERNEL_TOL})")
    require(fo2.shape == (4, NC, 2, NRO, NRO) and e <= KERNEL_TOL, f"koosh nt 2 forward {e:.3e}")
    del k2, o2, p2, f2, fo2, fp2

    # -- 21 kstream: tron-torch -3 --stream on the same stack ------------------
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "stack.ra"), os.path.join(tmp, "out.ra")
        t0 = time.perf_counter()
        ra_write(kdata, fin)
        log("kstream", f"wrote the stack {kdata.shape} complex64, {os.path.getsize(fin) / 1e6:.1f} "
            f"MB, in {time.perf_counter() - t0:.2f} s")
        for name, extra, env in (
            ("--stream", [], {}),
            ("--stream --half", ["--half"], {}),
            ("TRON_BATCHED=1 --stream", [], {"TRON_BATCHED": "1"}),
        ):
            os.environ.update(env)
            fresh_counts()
            t0 = time.perf_counter()
            try:
                rc = cli.main(["-3", "-a", "-G", "-u", "0.4", "--stream", "-g", "0", *extra, fin, fout])
            finally:
                for k in env:
                    os.environ.pop(k)
            wall = time.perf_counter() - t0
            require(rc == 0, f"-3 {name}: exit {rc}")
            kernel = "grid_radial2d_batched" if env else "grid_radial2d"
            counts = counts_now()
            counted({kernel: NPE2 * KNZI}, f"-3 {name}")
            res = ra_read(fout)
            if "--half" in extra:
                require(res.shape == (2, 1, 1, n_img, n_img, NPE2 * KNZI) and res.dtype == np.float16,
                        f"-3 {name}: {res.shape} {res.dtype}")
                pair = res[:, 0, 0].transpose(0, 3, 2, 1)
                frames = pair[0].astype(np.float32) + 1j * pair[1].astype(np.float32)
                ref, what = kouts[True][:, 0], "in-memory -3 with float16 readback"
            else:
                require(res.shape == (1, 1, n_img, n_img, NPE2 * KNZI) and res.dtype == np.complex64,
                        f"-3 {name}: {res.shape} {res.dtype}")
                frames = res[0, 0].transpose(2, 1, 0)
                ref, what = kout[:, 0], "in-memory -3"
            e = nrmse(frames, ref)
            same = np.array_equal(frames, ref)
            log("kstream", f"tron-torch -3 -a -G -u 0.4 {name}: file to file {wall:.3f} s host wall = "
                f"{NPE2 * NC * NRO * KNPE1 / wall / 1e6:.1f} Msamples/s; launches {counts}; vs {what}: "
                f"nrmse {e:.3e}, bitwise equal {same} on {card}")
            require(e <= 1e-5, f"-3 {name}: nrmse {e:.3e} vs {what}")
            os.remove(fout)
    del kouts  # the stack and its images stay for phase 25

    # -- 22 walsh and in-memory coil compression --------------------------------
    NW = 64
    wcfg = dataclasses.replace(cfg, coil_combine="walsh")
    win = np.ascontiguousarray(indata[..., : work + (NW - 1) * SLIDE])
    fresh_counts()
    t0 = time.perf_counter()
    wout = recon_radial2d(win, wcfg, device=dev)
    wall = time.perf_counter() - t0
    log("walsh", f"recon_radial2d -a -G -u 0.4 -d {SLIDE} --combine walsh on {NW} whole-body frames: "
        f"out {wout.shape}, launches {counts_now()}, host wall {wall:.3f} s (incl. transfers); "
        f"|walsh| vs the SoS recon: nrmse {nrmse(np.abs(wout[:, 0]), np.abs(outs['direct'][:NW])):.3e} "
        f"(random data, not a bound)")
    counted({"grid_radial2d": NW}, "walsh")
    require(wout.shape == (NW, 1, n_img, n_img) and bool(np.isfinite(wout).all()), "walsh output")
    # Walsh's 5 power iterations vs the dominant eigenvector of the same boxed
    # covariance from a float64 dense eigen-solve, on 2 frames of the 6-coil
    # phantom (coil images have a dominant eigenvector per pixel; noise has not)
    wang = spoke_angles(work + SLIDE, "golden", 0, device=dev)
    wdata = nufft_forward(pimg, wang, scfg)
    ncfg = dataclasses.replace(cfg, coil_combine="none")
    cimgs = recon_frames(wdata, ncfg, work, SLIDE, 2)      # (2, nc, n, n)
    wimgs = recon_frames(wdata, wcfg, work, SLIDE, 2)      # (2, n, n)
    for z in range(2):
        c = cimgs[z].to(torch.complex128)
        cov = coil._box_filter(torch.einsum("iyx,jyx->ijyx", c, c.conj()), wcfg.walsh_npatch)
        _, vecs = torch.linalg.eigh(cov.permute(2, 3, 0, 1).cpu())
        v = vecs[..., -1].permute(2, 0, 1).to(dev)         # dominant eigenvector per pixel
        dense = (v.conj() * c).sum(0).abs()
        e = nrmse(wimgs[z].abs().double(), dense)
        log("walsh", f"phantom frame {z}: |Walsh, 5 power iterations| vs |float64 dense eigen-solve|: "
            f"nrmse {e:.3e} (tol 1e-3)")
        require(e <= 1e-3, f"walsh vs dense eigen-solve frame {z}: {e:.3e}")
    ci0 = cimgs[0].contiguous()
    t_w = [timed(lambda: coil.coil_combine_sos(ci0), 20), timed(lambda: coil.coil_combine_walsh(ci0, 1), 20),
           timed(lambda: coil.coil_combine_walsh(ci0, 1), 20), timed(lambda: coil.coil_combine_sos(ci0), 20)]
    walsh_ms = 1e3 * (t_w[1] + t_w[2]) / 2
    log("walsh", f"one frame of 6 x 256^2 coil images: Walsh (npatch 1, 5 iterations) {walsh_ms:.4f} ms, "
        f"SoS {1e3 * (t_w[0] + t_w[3]) / 2:.4f} ms (sos, walsh, walsh, sos: "
        f"{[round(1e3 * t, 4) for t in t_w]}) on {card}")
    # --compress 3 in memory (eigh of the coil Gram matrix on the card) vs
    # --stream --compress 3 (the basis from a disk pass): the same series with
    # coil c scaled by 1 - 0.12 c, so that its top-3 coil subspace is well
    # separated (iid coils have a degenerate Gram spectrum)
    with tempfile.TemporaryDirectory() as tmp:
        fin = os.path.join(tmp, "scaled.ra")
        scale = (1 - 0.12 * np.arange(NC, dtype=np.float32)).reshape(NC, 1, 1, 1)
        ra_write((win * scale).astype(np.complex64)[..., None], fin)
        imgs = {}
        for name, extra in (("in memory", []), ("--stream", ["--stream"])):
            fout = os.path.join(tmp, f"c{len(imgs)}.ra")
            fresh_counts()
            t0 = time.perf_counter()
            rc = cli.main(["-a", "-G", "-u", "0.4", "-d", str(SLIDE), "--compress", "3", "-g", "0",
                           *extra, fin, fout])
            wall = time.perf_counter() - t0
            require(rc == 0, f"--compress 3 {name}: exit {rc}")
            log("compress", f"tron-torch -a -G -u 0.4 -d {SLIDE} --compress 3 {name}: {wall:.3f} s host "
                f"wall, launches {counts_now()}")
            counted({"grid_radial2d": NW}, f"--compress 3 {name}")
            imgs[name] = ra_read(fout)
            require(imgs[name].shape == (1, 1, n_img, n_img, NW), f"--compress dims {imgs[name].shape}")
        e = nrmse(np.abs(imgs["in memory"]), np.abs(imgs["--stream"]))
        log("compress", f"SoS images of 3 virtual coils, in memory vs --stream: nrmse {e:.3e} (tol 1e-4)")
        require(e <= 1e-4, f"--compress in memory vs --stream: {e:.3e}")
    del win, wout, imgs

    # -- 23 cli3: the rest of the CLI and the fixture tools -----------------------
    from tron_tpu_torch.tools import make_goldenangle, make_phantom

    with tempfile.TemporaryDirectory() as tmp:
        path = lambda name: os.path.join(tmp, name)  # noqa: E731
        make_phantom.main([path("sl.ra"), "--n", str(n_img)])
        truth = np.abs(shepp_logan(n_img)).T.ravel()

        def corr(f):
            return float(np.corrcoef(np.abs(ra_read(f)[0, 0, :, :, 0]).ravel(), truth)[0, 1])

        fresh_counts()
        require(cli.main(["-g", "0", path("sl.ra"), path("data.ra")]) == 0, "cli3 forward")
        require(cli.main(["-a", "--scheme", "linear_half", "-B", "4096", "-T", "128", "-g", "0",
                          path("data.ra"), path("img.ra")]) == 0, "cli3 adjoint -B -T")
        counted({"grid_radial2d": 1, "degrid_radial2d": 1}, "cli3 roundtrip")
        c = corr(path("img.ra"))
        log("cli3", f"make_phantom --n {n_img} -> tron-torch -> tron-torch -a --scheme linear_half "
            f"-B 4096 -T 128: data dims {ra_read(path('data.ra')).shape}, correlation with the "
            f"phantom {c:.4f} (> 0.9)")
        require(c > 0.9, f"linear-angle roundtrip correlation {c:.4f}")
        fresh_counts()
        require(cli.main(["-k", "4", "-g", "0", path("sl.ra"), path("d4.ra")]) == 0, "cli3 -k 4 forward")
        require(cli.main(["-a", "-k", "4", "-i", "2", "--scheme", "linear_half", "-g", "0",
                          path("d4.ra"), path("i4.ra")]) == 0, "cli3 -k 4 -i 2")
        counted({"grid_radial2d": 3, "degrid_radial2d": 3}, "cli3 -k 4")
        r4 = ra_read(path("i4.ra"))
        log("cli3", f"tron-torch -k 4 forward, then -a -k 4 -i 2 --scheme linear_half: out dims "
            f"{r4.shape}, correlation with the phantom {corr(path('i4.ra')):.4f}")
        require(r4.shape == (1, 1, n_img, n_img, 1) and bool(np.isfinite(r4).all()), "cli3 -k 4 output")
        base_img = ra_read(path("img.ra"))
        for flags in (["--backend", "pallas"], ["--precision", "accurate"],
                      ["--profile", path("prof")], ["--dft-dot", "highest"]):
            fresh_counts()
            require(cli.main(["-a", "--scheme", "linear_half", *flags, "-g", "0", path("data.ra"),
                              path("o.ra")]) == 0, f"cli3 {flags}")
            counted({"grid_radial2d": 1}, f"cli3 {flags[0]}")
            img = ra_read(path("o.ra"))
            same = np.array_equal(img, base_img)
            e = nrmse(img, base_img)
            log("cli3", f"tron-torch -a --scheme linear_half {flags[0]} {flags[1] if flags[0] != '--profile' else 'DIR'}: "
                f"bitwise equal to the default run: {same}, nrmse {e:.3e}")
            if flags[0] == "--precision":  # bf16x3 against the default's bfloat16
                require(1e-5 < e < 1e-2, f"cli3 --precision accurate vs fast: nrmse {e:.3e}")
            else:
                require(same, f"cli3 {flags[0]} changed the images")
        traces = [f for f in os.listdir(path("prof")) if f.endswith(".trace.json")]
        require(len(traces) == 1, f"--profile wrote {traces}")
        with open(os.path.join(path("prof"), traces[0])) as f:
            trace = f.read()
        log("cli3", f"--profile DIR: {traces[0][:11]}...trace.json, {len(trace) / 1e3:.0f} kB, names "
            f"tron.grid_radial2d: {'tron.grid_radial2d' in trace}, tron.frame: "
            f"{'tron.frame' in trace}, the contraction pass: {'grid_tile_contract_kernel' in trace}")
        require("tron.grid_radial2d" in trace and "tron.frame" in trace
                and "grid_tile_contract_kernel" in trace,
                "the --profile trace does not name the gridding kernel and the frames")
        fresh_counts()
        rc = cli.main(["-a", "-k", "7", "-g", "0", path("data.ra"), path("o7.ra")])
        log("cli3", f"tron-torch -a -k 7: exit {rc}, launches {sum(counts_now().values())}")
        require(rc == 2 and not os.path.exists(path("o7.ra")) and not sum(counts_now().values()),
                "-k 7 must exit 2 before any work")
        # the recipe's golden-angle multicoil path at nxos 128: B2's contract
        # (grids that do not tile in the Pallas kernel) on B1's kernel
        fresh_counts()
        make_goldenangle.main([path("ga.ra"), "--nc", "4", "--nro", "128", "--npe", "96"])
        counted({"degrid_radial2d": 1}, "make_goldenangle")
        fresh_counts()
        require(cli.main(["-a", "-G", "-u", "0.5", "-d", "21", "-g", "0", path("ga.ra"),
                          path("ga_img.ra")]) == 0, "cli3 golden-angle fixture")
        b2_launches = grid_cuda.LAUNCH_COUNTS["grid_radial2d"]
        require(counts_now() == {**dict.fromkeys(grid_cuda.KERNELS, 0), "grid_radial2d": 2,
                                 "degrid_radial2d": 0}, f"cli3 golden-angle launches {counts_now()}")
        ga = ra_read(path("ga_img.ra"))
        cga = float(np.corrcoef(np.abs(ga[0, 0, :, :, 0]).ravel(), np.abs(shepp_logan(64)).T.ravel())[0, 1])
        log("cli3", f"make_goldenangle --nc 4 --nro 128 --npe 96 -> tron-torch -a -G -u 0.5 -d 21: out "
            f"dims {ga.shape}, {b2_launches} launches at nxos 128, correlation with the phantom {cga:.4f}")
        require(ga.shape == (1, 1, 64, 64, 2) and bool(np.isfinite(ga).all()), "cli3 golden-angle output")
    # -- 24 shard1: the sharded scheduler at a world of 1, on NCCL -------------
    import torch.distributed as dist

    from tron_tpu_torch.parallel import distributed, launch, make_mesh, recon_frames_sharded

    ncards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(device=dev, init_method=f"file://{tmp}/store", rank=0, world_size=1)
        ones = torch.ones(4, device=dev)
        dist.all_reduce(ones)
        require(dist.get_backend() == "nccl" and bool((ones == 1).all()),
                f"a world of 1 on {dist.get_backend()}: all_reduce gave {ones.tolist()}")
        mesh1 = make_mesh(1, 1, device=dev)
        require(mesh1.shape == {"frame": 1, "coil": 1} and mesh1.device == dev, f"mesh {mesh1}")
        for mode, fn in (("direct", recon_frames), ("incremental", recon_frames_incremental)):
            c = dataclasses.replace(cfg, incremental=mode == "incremental")
            fresh_counts()
            ref = fn(dfull, c, work, SLIDE, NZ)
            plain_counts = {k: v for k, v in counts_now().items() if v}
            fresh_counts()
            got = recon_frames_sharded(dfull, c, mesh1, work, SLIDE, NZ)
            counted({"grid_radial2d": NZ}, f"shard1 {mode}")
            require(plain_counts == {"grid_radial2d": NZ}, f"shard1 {mode}: unsharded {plain_counts}")
            same = torch.equal(got, ref)
            e = nrmse(got, ref)
            del got, ref
            unsharded = lambda: fn(dfull, c, work, SLIDE, NZ)  # noqa: E731
            sharded = lambda: recon_frames_sharded(dfull, c, mesh1, work, SLIDE, NZ)  # noqa: E731
            t = [timed(unsharded, 2), timed(sharded, 2), timed(sharded, 2), timed(unsharded, 2)]
            log("shard1", f"{mode}, world 1 on nccl, 1 card, mesh 1 x 1, {NZ} whole-body frames: "
                f"recon_frames_sharded vs {fn.__name__}: nrmse {e:.3e}, bitwise equal {same}, "
                f"{NZ} launches of grid_radial2d each; ms per frame sharded "
                f"{1e3 * (t[1] + t[2]) / 2 / NZ:.4f}, unsharded {1e3 * (t[0] + t[3]) / 2 / NZ:.4f} "
                f"(unsharded, sharded, sharded, unsharded: {[round(1e3 * x / NZ, 4) for x in t]}) "
                f"on {card}")
            require(e <= 1e-6, f"shard1 {mode}: nrmse {e:.3e} vs the unsharded scheduler")
        distributed.shutdown()

    # -- 25 shard2: two ranks on the card --------------------------------------
    NS, NN = 64, 16                    # frames; frames of the coil-image ('none') calls
    host64 = np.ascontiguousarray(host[:, : work + (NS - 1) * SLIDE])
    host16 = np.ascontiguousarray(host[:, : work + (NN - 1) * SLIDE])
    # Walsh wants coil images with a dominant eigenvector: the phantom's
    pang = spoke_angles(work + (NS - 1) * SLIDE, "golden", 0, device=dev)
    ph64 = nufft_forward(pimg, pang, scfg).cpu().numpy()
    window = np.ascontiguousarray(host[:, :work])
    icfg = dataclasses.replace(cfg, incremental=True)
    spoke_cfgs = {"adjoint": cfg, f"-i {NITER}": ccfg, f"-i {NITER} --toeplitz": tcfg}

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    # the unsharded recons, here in the parent
    refs = {
        "sos": outs["direct"][:NS],
        "walsh": recon_frames(dev_t(ph64), wcfg, work, SLIDE, NS).cpu().numpy(),
        "none": recon_frames(dev_t(host16), ncfg, work, SLIDE, NN).cpu().numpy(),
        "forward": recon_radial2d(fimgs, fcfg, device=dev),
        "forward -3": recon_radial2d(kimgs, kfcfg, device=dev),
        "-3": kout,
    }
    for name, c in spoke_cfgs.items():
        refs[f"spoke {name}"] = recon_mod.reconstruct_frame(dev_t(window), 0, c).cpu().numpy()

    # (label, call, reference, limit, worst frame?, launches per rank: grid, degrid)
    plan = []

    def frames_call(shape, label, c, data, nfr, ref, tol):
        per = nfr // shape["frame"]
        plan.append((f"mesh {shape['frame']} x {shape['coil']} {label}",
                     dict(entry="recon_frames_sharded", mesh=shape, cfg=c,
                          args=[data, work, SLIDE, nfr, 0]),
                     ref, tol, c.incremental, (per, 0)))

    for shape, tol in (({"frame": 2, "coil": 1}, 1e-6), ({"frame": 1, "coil": 2}, 1e-5)):
        frames_call(shape, "sos direct", cfg, host64, NS, refs["sos"], tol)
        frames_call(shape, "sos incremental", icfg, host64, NS, refs["sos"], INC_TOL)
        frames_call(shape, "walsh direct", wcfg, ph64, NS, refs["walsh"], tol)
        frames_call(shape, "walsh incremental", dataclasses.replace(wcfg, incremental=True), ph64,
                    NS, refs["walsh"], INC_TOL)
        frames_call(shape, "none direct", ncfg, host16, NN, refs["none"], tol)
        frames_call(shape, "none incremental", dataclasses.replace(ncfg, incremental=True), host16,
                    NN, refs["none"], INC_TOL)
    for name, c in spoke_cfgs.items():
        n_grid = 1 if c.niter == 0 else 2 if c.toeplitz else NITER + 1
        plan.append((f"spoke mesh 2, {name}",
                     dict(entry="recon_window_spoke_sharded", mesh={"spoke": 2}, cfg=c,
                          args=[window, 0]),
                     refs[f"spoke {name}"], KERNEL_TOL if c.niter == 0 else CG_TOL, False,
                     (n_grid, 0 if c.niter == 0 or c.toeplitz else NITER)))
    two = {"frame": 2, "coil": 1}
    plan.append(("mesh 2 x 1 forward, 32 slices",
                 dict(entry="recon_forward_sharded", mesh=two, cfg=fcfg, args=[fimgs]),
                 refs["forward"], 1e-6, False, (0, NF // 2)))
    plan.append(("mesh 2 x 1 forward -3, 32 slices",
                 dict(entry="recon_forward_sharded", mesh=two, cfg=kfcfg, args=[kimgs]),
                 refs["forward -3"], 1e-6, False, (0, NPE2 // 2)))
    plan.append(("mesh 2 x 1 -3 adjoint, 32 kz x 4 frames",
                 dict(entry="recon_stack_of_stars_sharded", mesh=two, cfg=kcfg, args=[kdata]),
                 refs["-3"], 1e-6, False, (NPE2 // 2 * KNZI, 0)))
    # repeats, to be bitwise equal to their first run: a coil-sharded recon
    # (one all_reduce per frame) and the spoke-sharded adjoint
    repeats = {len(plan): 6, len(plan) + 1: 12}
    plan.append(plan[6])
    plan.append(plan[12])
    want_launch = {"grid_radial2d": sum(p[5][0] for p in plan), "grid_radial2d_batched": 0,
                   "grid_seg_radial2d": 0, "degrid_radial2d": sum(p[5][1] for p in plan)}

    def shard2(cards: int):
        t0 = time.perf_counter()
        res = launch.start_ranks("tron_tpu_torch.parallel.launch:run_calls", 2,
                                 {"calls": [p[1] for p in plan], "digests": True},
                                 cards=cards, timeout=600.0)
        wall = time.perf_counter() - t0
        backend = "gloo" if cards == 1 else "nccl"
        where = f"2 ranks on {backend}, {cards} card{'s' if cards > 1 else ''} ({[r.device for r in res]})"
        for r in res:
            require(r.backend == backend and r.imported == (), f"shard2: {r.backend} {r.imported}")
            require(r.launches == want_launch, f"shard2 {where}: launches {r.launches}, expected "
                    f"{want_launch}")
            for k, v in r.launches.items():
                new_counts[k] += v
        for i, (label, _, ref, tol, worst, _) in enumerate(plan):
            got = res[0].value["results"][i]
            require(got.shape == ref.shape and got.dtype == ref.dtype,
                    f"shard2 {label}: {got.shape} {got.dtype}, expected {ref.shape} {ref.dtype}")
            require(res[1].value["results"][i] == launch.digest(got),
                    f"shard2 {label}: rank 1 holds another result than rank 0")
            if i in repeats:
                same = np.array_equal(got, res[0].value["results"][repeats[i]])
                log("shard2", f"{where}: {label}, again: bitwise equal {same}; "
                    f"{1e3 * res[0].value['seconds'][i]:.2f} ms in rank 0 (host clock, synchronised)")
                require(same, f"shard2 {label}: a repeat run is not bitwise equal")
                continue
            if worst:
                e = max(nrmse(got[z], ref[z]) for z in range(ref.shape[0]))
            else:
                e = nrmse(got, ref)
            log("shard2", f"{where}: {label} vs the unsharded recon: "
                f"{'worst-frame ' if worst else ''}nrmse {e:.3e} (tol {tol}), bitwise equal "
                f"{np.array_equal(got, ref)}; {1e3 * res[0].value['seconds'][i]:.2f} ms in rank 0 "
                f"(host clock, a first call of its kind)")
            require(bool(np.isfinite(got).all()) and e <= tol, f"shard2 {label}: nrmse {e:.3e} > {tol}")
        log("shard2", f"{where}: {len(plan)} sharded calls in one start of ranks, host wall "
            f"{wall:.2f} s (processes, transfers and {sum(p[2].nbytes for p in plan) / 1e9:.2f} GB "
            f"of results included); launches per rank {want_launch} on {card}")

    shard2(1)
    if ncards >= 2:
        shard2(2)
    else:
        log("shard2", f"{ncards} card visible: the NCCL run on two cards is left out")
    del refs, plan, kT, kdata, kout, host64, host16, ph64

    # -- 26 clishard: tron-torch --shard, --shard-spokes, --stream --shard ------
    with tempfile.TemporaryDirectory() as tmp:
        path = lambda name: os.path.join(tmp, name)  # noqa: E731
        ra_write(np.ascontiguousarray(indata[..., :1479])[..., None], path("in.ra"))
        base = ["-a", "-G", "-u", "0.4", "-d", str(SLIDE), "-g", "0"]
        require(cli.main(base + [path("in.ra"), path("ref.ra")]) == 0, "clishard reference")
        ref = ra_read(path("ref.ra"))
        for extra, env in ((["--shard"], {}), (["--shard-spokes"], {}), (["--stream", "--shard"], {}),
                           (["--stream", "--shard"], {"TRON_BATCHED": "1"})):
            name = " ".join([f"{k}={v}" for k, v in env.items()] + extra)
            kernel = "grid_radial2d_batched" if env else "grid_radial2d"
            os.environ.update(env)
            fresh_counts()
            t0 = time.perf_counter()
            try:
                rc = cli.main(base + extra + [path("in.ra"), path("out.ra")])
            finally:
                for k in env:
                    os.environ.pop(k)
            wall = time.perf_counter() - t0
            require(rc == 0, f"tron-torch {name}: exit {rc}")
            if ncards == 1:   # in this process; with more cards main() starts a rank on each
                counted({kernel: 61}, f"tron-torch {name}")
            got = ra_read(path("out.ra"))
            same = np.array_equal(got, ref)
            e = nrmse(got, ref)
            log("clishard", f"tron-torch -a -G -u 0.4 -d {SLIDE} {name} ({kernel}) on (6, 1, 512, 1479, 1), "
                f"{ncards} card{'s' if ncards > 1 else ', a world of 1 in this process'}: {wall:.3f} s "
                f"host wall; vs the unsharded file: nrmse {e:.3e}, bitwise equal {same}")
            require(got.shape == ref.shape and e <= (1e-6 if ncards == 1 and not env else 1e-5),
                    f"tron-torch {name}: nrmse {e:.3e}")
            os.remove(path("out.ra"))
            if env:   # the ranks below take the default kernel again
                continue
            # the same command as the two ranks of a world of 2 on one card
            t0 = time.perf_counter()
            res = launch.start_ranks("tron_tpu_torch.cli:rank_main", 2,
                                     {"argv": base + extra + [path("in.ra"), path("out.ra")]},
                                     cards=1, timeout=300.0)
            wall = time.perf_counter() - t0
            require([r.value for r in res] == [0, 0], f"tron-torch {name} in 2 ranks: {res}")
            got = ra_read(path("out.ra"))
            e = nrmse(got, ref)
            grid_launches = [r.launches["grid_radial2d"] for r in res]
            for r in res:
                for k, v in r.launches.items():
                    new_counts[k] += v
            log("clishard", f"tron-torch {name} as 2 ranks on {res[0].backend}, 1 card: {wall:.2f} s "
                f"host wall (processes included), grid_radial2d launches per rank {grid_launches}; "
                f"rank 0's file vs the unsharded file: nrmse {e:.3e}, bitwise equal "
                f"{np.array_equal(got, ref)}")
            frames_split = [31, 30] if "--shard" in extra else [61, 61]
            require(grid_launches == frames_split, f"tron-torch {name} in 2 ranks: {grid_launches}")
            require(e <= (1e-5 if "--shard-spokes" in extra else 1e-6),
                    f"tron-torch {name} in 2 ranks: nrmse {e:.3e}")
            os.remove(path("out.ra"))
    # -- 27 classes: the paper's four dataset classes at full size -------------
    # (late in this process its host-bound times run slower than the tools
    # alone in a fresh process, which PERF.md reports)
    from tron_tpu_torch.tools import floor_dissect, inc_dissect, paper_plots

    t27 = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        fresh_counts()
        t0 = time.perf_counter()
        rows = paper_plots.measure_timings(os.path.join(tmp, "timings.csv"), dev)
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "timings.csv"), newline="") as fh:
            written = list(csv.DictReader(fh))
    counted({"grid_radial2d": 5 * sum(r["frames"] for r in rows)}, "paper_plots.measure_timings")
    require([r["dataset"] for r in written] == [d[0] for d in paper_plots.DATASETS]
            and all(r["card"] == torch.cuda.get_device_name(0) for r in written),
            f"timings.csv rows {written}")
    # each class's first frame, on the data measure_timings drew, against the
    # plain operators (comparison launches: not counted)
    crng = np.random.default_rng(0)
    for dataset, r in zip(paper_plots.DATASETS, rows):
        ccfg, cwork, cslide, cnz, cdata = paper_plots.class_case(dataset, crng)
        win = torch.from_numpy(np.ascontiguousarray(cdata[:, :cwork])).to(dev)
        del cdata
        e = nrmse(recon_frames(win, dataclasses.replace(ccfg, matmul_dtype="float32"), cwork, cslide, 1),
                  recon_frames(win, dataclasses.replace(ccfg, backend="jnp"), cwork, cslide, 1))
        log("classes", f"{r['dataset']} ({dataset[2]} coils, nro {dataset[3]}, {cwork} spokes per "
            f"frame, {r['frames']} frames): {r['card_s']:.6f} s host clock, {r['event_s']:.6f} s CUDA "
            f"events = {r['card_msamples_per_s']:.1f} Msamples/s, {r['speedup']:.2f}x the paper GPU's "
            f"{r['ref_gpu_s']} s; {r['grid_launches']} launches of grid_radial2d; frame 0 vs the "
            f"plain operators nrmse {e:.3e} (tol {KERNEL_TOL}) on {card}")
        require(r["grid_launches"] == 5 * cnz and r["frames"] == cnz,
                f"{r['dataset']}: {r['grid_launches']} launches for {cnz} frames")
        require(e <= KERNEL_TOL and np.isfinite(r["checksum"]) and r["checksum"] > 0,
                f"{r['dataset']}: frame 0 nrmse {e:.3e}, checksum {r['checksum']}")
    log("classes", f"paper_plots.measure_timings: 4 classes in {wall:.2f} s host wall (data "
        f"drawn and uploaded included)")
    del win

    # -- 28 floor: the per-run constant of the three small classes --------------
    fresh_counts()
    fl = floor_dissect.main(["--device", "0"])
    # per class: 7 + 63 recons of the slope, 1 profiled, 7 + 1 of the readback
    require([r["frames"] for r in fl["classes"]] == [17, 1, 137], f"floor frames {fl}")
    counted({"grid_radial2d": 79 * (17 + 1 + 137)}, "floor_dissect")
    for r in fl["classes"]:
        log("floor", f"{r['class']} ({r['frames']} frames): wall {r['wall_ms']} ms = rtt "
            f"{r['rtt_ms']} + device (slope) {r['device_ms']} + residual {r['residual_ms']}; card busy "
            f"{r['busy_ms']} ms ({r['busy_pct']} % of the wall); {r['e2e_msamples_per_s']} Msamples/s "
            f"end to end, {r['device_msamples_per_s']} by the slope; image readback +{r['d2h_ms']} ms "
            f"for {r['d2h_mb']} MB on {card}")
        require(r["wall_ms"] > 0 and r["busy_ms"] is not None and 0 < r["busy_ms"] <= r["wall_ms"],
                f"floor {r['class']}: {r}")

    # -- 29 incdis: the incremental headline split, 956 frames ------------------
    fresh_counts()
    os.environ.update(DISSECT_FRAMES=str(NZ), DISSECT_NRO=str(NRO))
    try:
        inc = inc_dissect.main(["--device", "0"])
    finally:
        for k in ("DISSECT_FRAMES", "DISSECT_NRO"):
            os.environ.pop(k)
    counted({"grid_radial2d": 10 * NZ}, "inc_dissect")   # full and grid_only, 5 runs each
    log("incdis", f"{NZ} whole-body frames: full {inc['full_s']:.6f} s ({inc['full_event_s']:.6f} s "
        f"CUDA events, {inc['full_msps']:.1f} Msamples/s), grid_only {inc['grid_only_s']:.6f} s "
        f"({inc['grid_only_event_s']:.6f}), epi_only {inc['epi_only_s']:.6f} s "
        f"({inc['epi_only_event_s']:.6f}) on {card}")
    require(inc["frames"] == NZ and all(np.isfinite(inc[k]) and inc[k] > 0 for k in inc
                                        if k.endswith("_s")), f"inc_dissect {inc}")

    # -- 30 runme: the three recipes, each command a process of its own --------
    from tron_tpu_torch.io import ra_query

    def start_recipe(name, env, logdir):
        """sh scripts/NAME in a session of its own (each step of it a
        process), its output to a file in logdir."""
        with open(os.path.join(logdir, name + ".log"), "w") as out:
            p = subprocess.Popen(["sh", os.path.join(ROOT, "scripts", name)], env=env, text=True,
                                 stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
        return {"name": name, "p": p, "t0": time.perf_counter()}

    def recipe_done(run, logdir):
        """The recipe has exited: it must have exited 0."""
        wall = time.perf_counter() - run["t0"]
        rc = run["p"].returncode
        with open(os.path.join(logdir, run["name"] + ".log")) as fh:
            so = fh.read()
        require(rc == 0, f"{run['name']}: exit {rc}\n{so[-6000:]}")
        elapsed = [float(m) for m in re.findall(r"^elapsed: ([0-9.]+) s", so, re.M)]
        log("runme", f"sh scripts/{run['name']}{run.get('note', '')}: exit {rc}, {wall:.2f} s host "
            f"wall" + (f"; its timed recons {elapsed} s" if elapsed else "") + f" on {card}")

    with tempfile.TemporaryDirectory() as tmp:
        bindir, out = os.path.join(tmp, "bin"), os.path.join(tmp, "out")
        os.mkdir(bindir)
        with open(os.path.join(bindir, "python"), "w") as fh:  # the recipes' `python` is this one
            fh.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(os.path.join(bindir, "python"), 0o755)
        env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}",
                   TRON_OUT=out)
        t30 = time.perf_counter()
        # RUNME2 beside RUNME1, then RUNME3 (which reads RUNME1's file); every
        # recipe's session is killed on the phase's time limit or a failure
        running = [start_recipe("torch_RUNME2_compare_degrid.sh", env, tmp),
                   start_recipe("torch_RUNME1_tron_degrid_phantom.sh", env, tmp)]
        try:
            while running:
                require(time.perf_counter() - t30 < 900, f"recipes still running: {running}")
                for run in [r for r in running if r["p"].poll() is not None]:
                    running.remove(run)
                    recipe_done(run, tmp)
                    if run["name"].startswith("torch_RUNME1"):
                        running.append(start_recipe("torch_RUNME3_tron_grid_all.sh",
                                                    dict(env, TRON_FULLSCALE="0"), tmp))
                        running[-1]["note"] = " (TRON_FULLSCALE=0)"
                time.sleep(0.2)
        finally:
            for run in running:
                if run["p"].poll() is None:
                    os.killpg(run["p"].pid, signal.SIGKILL)
                    run["p"].wait()
        log("runme", f"the three recipes, RUNME2 beside RUNME1 then RUNME3: "
            f"{time.perf_counter() - t30:.2f} s host wall; phases 27-30 "
            f"{time.perf_counter() - t27:.2f} s")
        want = {  # the dims of the JAX recipes' files: (nc, nt, nro, npe1, nz), (1, nt, n, n, nz)
            "shepplogan.ra": (1, 1, 256, 256, 1),
            "sl_data_tron.ra": (1, 1, 512, 512, 1),
            "sl_img_tron.ra": (1, 1, 256, 256, 1),
            "ga_multicoil.ra": (6, 1, 512, 1479, 1),
            "ga_img_tron.ra": (1, 1, 256, 256, 61),
            "optic_nerve.ra": (4, 1, 256, 2176, 1),
            "img_on_tron.ra": (1, 1, 128, 128, 17),
            "swallowing.ra": (4, 1, 256, 3000, 1),
            "img_sw_tron.ra": (1, 1, 128, 128, 137),
        }
        got = {f: tuple(ra_query(os.path.join(out, f)).dims) for f in want}
        log("runme", f"files and dims: {got}")
        require(got == want, f"recipe outputs {got}, expected {want}")
        for f in ("sl_img_tron.ra", "ga_img_tron.ra", "img_on_tron.ra", "img_sw_tron.ra"):
            require(bool(np.isfinite(ra_read(os.path.join(out, f))).all()), f"{f} not finite")
        with open(os.path.join(out, "dataset_metrics.csv"), newline="") as fh:
            metrics = list(csv.DictReader(fh))
        with open(os.path.join(out, "compare_n64_npe128.csv"), newline="") as fh:
            compare = {r["method"]: r for r in csv.DictReader(fh)}
        log("runme", f"dataset_metrics.csv: {[(r['label'], r['frame'], r['ssim_vs_xla']) for r in metrics]}; "
            f"compare_recon --golden: nrmse vs the oracle "
            f"{ {k: v['nrmse_vs_ref'] for k, v in compare.items()} }")
        require([(r["label"], r["frame"]) for r in metrics]
                == [("optic_nerve", "0"), ("optic_nerve", "16"), ("swallowing", "0"),
                    ("swallowing", "60"), ("swallowing", "136")], f"dataset_metrics rows {metrics}")
        require(all(float(r["ssim_vs_xla"]) > 0.999 for r in metrics), "kernel vs plain ssim")
        require(set(compare) == {"tron-jnp", "tron-pallas", "oracle"}, f"compare rows {compare}")
    log("paths", f"launches of phases 20-29 by kernel: {new_counts}; at nxos 128 (B2's contract): "
        f"{b2_launches}")

    g_bound, g_by = grid_bound(wb_planes, wb_ang, 512)
    d_bound, d_by = degrid_bound(kg, dang, NRO)
    # B2's contract (_grid_kernel: grids that do not tile, nxos < 256) runs on
    # the same kernel; timed at the size of tests/test_grid_pallas.py:37-43
    s_planes, s_ang = planes_case(128, 2, 12, 5)
    b2k = lambda: grid_cuda.grid_radial2d_planes(s_planes, s_ang, 128, kw, beta)  # noqa: E731
    b2p = lambda: grid_radial2d_planes_plain(s_planes, s_ang, 128, kw, beta)  # noqa: E731
    t2 = [timed(b2p, 20), timed(b2k, 200), timed(b2k, 200), timed(b2p, 20)]
    b2_bound, b2_by = grid_bound(s_planes, s_ang, 128)
    log("b2", f"nxos 128, 2 coils, 12 spokes: kernel {1e3 * (t2[1] + t2[2]) / 2:.4f} ms, plain "
        f"{1e3 * (t2[0] + t2[3]) / 2:.4f} ms (plain, kernel, kernel, plain: "
        f"{[round(1e3 * t, 4) for t in t2]}), bound {b2_bound * 1e3:.3f} us ({b2_by}) on {card}")
    log("bound", f"gridding one whole-body frame: {g_bound * 1e3:.3f} us ({g_by}); degridding one "
        f"CGNR frame: {d_bound * 1e3:.3f} us ({d_by}); H100 SXM {HBM_BYTES_PER_S / 1e12} TB/s, "
        f"{FP32_FLOPS / 1e12:g} TFLOP/s fp32")

    # -- 33 bench: python -m tron_tpu_torch.bench at full size, a fresh process
    torch.cuda.empty_cache()
    t33 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        p = subprocess.Popen([sys.executable, "-m", "tron_tpu_torch.bench"], cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=err, start_new_session=True)
        try:
            so, _ = p.communicate(timeout=BENCH_WALL)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
            so = ""
        err.seek(0)
        se = err.read()
    lines = so.strip().splitlines()
    require(bool(lines), f"bench: exit {p.returncode}, no result line\n{se[-6000:]}")
    log("bench", f"python -m tron_tpu_torch.bench: exit {p.returncode} in "
        f"{time.perf_counter() - t33:.1f} s; its line: {lines[-1]}")
    bres = json.loads(lines[-1])
    require(p.returncode == 0 and bres["errors"] == {}, f"bench errors {bres['errors']}\n{se[-6000:]}")
    require((bres["platform"], bres["mode"], bres["frames"], bres["degrid_frames"],
             bres["cgnr_series_frames"], bres["stream_frames"]) == ("gpu", "full", NZ, NZ, 137, NZ),
            f"bench ran {bres['platform']}, {bres['mode']}, frames {bres['frames']}")
    bad = [k for k in BENCH_KEYS if not (isinstance(bres.get(k), str) or all(
        np.isfinite(v) for v in np.atleast_1d(np.asarray(bres.get(k), dtype=float))))]
    require(not bad, f"bench keys missing or not finite: { {k: bres.get(k) for k in bad} }")
    for kernel, sections in BENCH_KERNELS.items():
        for name in sections:
            sec = bres["sections"][name]
            require(sec["route"] == "kernel" and sec["launches"][kernel] > 0,
                    f"bench section {name}: route {sec['route']}, launches {sec['launches']}")
    for key, tol in BENCH_TOL.items():
        require(bres[key] < tol, f"bench {key} {bres[key]:.3e} (tol {tol})")
    bench_launches = {k: sum(sec["launches"][k] for sec in bres["sections"].values())
                      for k in ("grid_radial2d", "degrid_radial2d")}
    log("bench", f"{bres['value']:.1f} Msamples/s ({bres['headline_mode']}), direct "
        f"{bres['direct_msamples_per_s']:.1f}, incremental {bres['incremental_msamples_per_s']:.1f}; "
        f"NRMSE incremental {bres['nrmse_incremental_vs_direct']:.2e}, bf16 "
        f"{bres['nrmse_bf16_vs_fp32']:.2e}, accurate {bres['nrmse_accurate_vs_fp32']:.2e}, JAX golden "
        f"{bres['nrmse_fp32_vs_jax_golden']:.2e}; launches {bench_launches}; sections' s "
        f"{ {k: round(v['wall_s'], 1) for k, v in bres['sections'].items()} } on {card}")

    require("jax" not in sys.modules, "JAX was imported")
    common = {"route": "cuda", "bound_ms": g_bound, "bound_by": g_by}

    def library(name, suffix=""):
        """Phase 32's library call for a kernel row: one torch.sparse.mm of
        the KB interpolation matrix (cuSPARSE SpMM), float32, timed in turns
        with the kernel; its device time, bound, nonzeros, index width,
        build time, error against the plain version, repeat and bf16 try."""
        r = lib[name]
        return {f"library_ms{suffix}": r["ms"], f"library_device_ms{suffix}": r["device_ms"],
                f"library_bound_ms{suffix}": r["bound_ms"],
                f"library_bound_by{suffix}": r["bound_by"], f"library_nnz{suffix}": r["nnz"],
                f"library_index{suffix}": r["index"], f"library_build_ms{suffix}": r["build_ms"],
                f"library_err{suffix}": r["err"], f"library_repeat_bitwise{suffix}": r["repeat_bitwise"],
                f"library_bf16{suffix}": r["bf16"],
                f"library_turn_kernel_ms{suffix}": r["kernel_ms"],
                f"library_turn_kernel_device_ms{suffix}": r["kernel_device_ms"]}

    def by_class(name, suffix=""):
        """Phase 31's device ms, error against the plain version and bound
        per class of one kernel row."""
        r = prec[name]
        return {f"kernel_ms_by_class{suffix}": r["ms"], f"err_by_class{suffix}": r["err"],
                f"bound_ms_by_class{suffix}": r["bound_ms"]}

    print(json.dumps({"kernels": [
        {
            "name": "grid_radial2d",
            "source": "tron_tpu_torch/csrc/grid_radial2d.cu",
            **by_class("grid_radial2d"),
            "replaces": "tron_tpu/ops/grid_pallas.py:933",
            "launches": launches + cg_grid + stream_b1 + new_counts["grid_radial2d"]
            + bench_launches["grid_radial2d"],
            "max_abs_err": err512,
            "ms": kern_ms,
            "kernel_ms": kern_dev_ms,
            "plain_ms": plain_ms,
            **common,
            **library("grid_radial2d"),
            **library("grid_radial2d (exact lattice)", "_exact"),
        },
        {
            # B2's contract (grids that do not tile in the Pallas kernel) runs
            # on B1's kernel: its row is that kernel at nxos 128
            "name": "grid_radial2d (nxos 128)",
            "source": "tron_tpu_torch/csrc/grid_radial2d.cu",
            **by_class("grid_radial2d (nxos 128)"),
            "replaces": "tron_tpu/ops/grid_pallas.py:485",
            "launches": b2_launches,
            "max_abs_err": err128,
            "ms": 1e3 * (t2[1] + t2[2]) / 2,
            "kernel_ms": lib["grid_radial2d (nxos 128)"]["kernel_device_ms"],
            "plain_ms": 1e3 * (t2[0] + t2[3]) / 2,
            **common,
            **library("grid_radial2d (nxos 128)"),
            "bound_ms": b2_bound,
            "bound_by": b2_by,
        },
        {
            "name": "grid_radial2d_batched",
            "source": "tron_tpu_torch/csrc/grid_radial2d_batched.cu",
            **by_class("grid_radial2d_batched"),
            "replaces": "tron_tpu/ops/grid_pallas.py:1161",
            "launches": stream_b5 + new_counts["grid_radial2d_batched"],
            "max_abs_err": bat_err,
            "ms": bat_ms,
            "kernel_ms": bat_dev_ms,
            "plain_ms": bat_plain_ms,
            **common,
            **library("grid_radial2d"),
        },
        {
            "name": "grid_seg_radial2d",
            "source": "tron_tpu_torch/csrc/grid_seg_radial2d.cu",
            **by_class("grid_seg_radial2d"),
            "replaces": "tron_tpu/ops/grid_pallas.py:366",
            "launches": kb["--no-windowed"]["launches"]["grid_seg_radial2d"],
            "max_abs_err": seg_err,
            "ms": seg_ms,
            "kernel_ms": seg_dev_ms,
            "plain_ms": seg_plain_ms,
            **common,
            **library("grid_radial2d"),
        },
        {
            "name": "degrid_radial2d",
            "source": "tron_tpu_torch/csrc/degrid_radial2d.cu",
            **by_class("degrid_radial2d"),
            **by_class("degrid_radial2d (kw 4)", "_kw4"),
            "replaces": "tron_tpu/ops/degrid_pallas.py:44",
            "launches": fwd_launches + fwd3_launches + cg_degrid + new_counts["degrid_radial2d"]
            + bench_launches["degrid_radial2d"],
            "max_abs_err": derr512,
            "max_abs_err_kw4": derr_wide[4.0],
            "max_abs_err_kw6.5": derr_wide[6.5],
            "ms": dkern_ms,
            "kernel_ms": dbare_ms,
            "plain_ms": dplain_ms,
            "wrap_edge_ms": b3_edge_ms,
            "forward_bf16x3_msamples_s": fwd3_rate,
            **common,
            **library("degrid_radial2d"),
            **library("degrid_radial2d (wrap)", "_wrap"),
            "bound_ms": d_bound,
            "bound_by": d_by,
        },
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
