#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tron_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA device

Phases, one line each (any failure raises and exits non-zero):
  1 env      card name and power limit, torch and CUDA versions
  2 build    nvcc builds csrc/*.cu for sm_90a into build/tron_tpu_torch/
  3 kernel   the CUDA gridding kernel vs its plain torch version on the card
  4 main     whole-body golden-angle sliding-window recon (6 coils, nro 512,
             204 spokes per frame, slide 21, 956 frames of 256^2) through
             recon_radial2d, direct and incremental, with launch counts
  5 golden   the committed JAX-computed golden images
  6 cli      tron-torch -a -G -u 0.4 -d 21 on a .ra fixture
  7 timing   throughput (CUDA events) and kernel vs plain ms per frame
Then the kernel table as one JSON line, the nvidia-smi line, and the result
line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NC, NRO, SLIDE, NZ = 6, 512, 21, 956  # whole-body class (bench.py:168-174)
KERNEL_TOL = 1e-5                     # kernel vs plain, NRMSE (fp32 sums in two orders)
INC_TOL = 1e-4                        # incremental vs direct worst frame (bench.py:266)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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
    from tron_tpu_torch.ops.grid import grid_radial2d as grid_dense
    from tron_tpu_torch.ops.grid import grid_radial2d_planes_plain
    from tron_tpu_torch.recon import (
        recon_frames,
        recon_frames_incremental,
        recon_radial2d,
    )
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
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    how = f"nvcc {' '.join(_build.NVCC_FLAGS)}" if built.log else "reused, same sources"
    log("build", f"{built.path.relative_to(ROOT)} from tron_tpu_torch/csrc/ "
        f"({how}) in {time.perf_counter() - t0:.2f} s")
    for ln in ptxas:
        log("build", f"ptxas: {ln}")

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
    ]
    err512 = None
    for name, nxos, C, npe, skip, signed in cases:
        planes, ang = planes_case(nxos, C, npe, skip, signed)
        got = grid_cuda.grid_radial2d_planes(planes, ang, nxos, kw, beta)
        want = grid_radial2d_planes_plain(planes, ang, nxos, kw, beta)
        torch.cuda.synchronize()
        e = nrmse(got, want)
        mae = float((got - want).abs().max())
        log("kernel", f"{name}: nrmse {e:.3e} max_abs_err {mae:.3e} (tol {KERNEL_TOL})")
        require(e <= KERNEL_TOL, f"kernel vs plain {name}: nrmse {e:.3e} > {KERNEL_TOL}")
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
        grid_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        out = recon_radial2d(indata, c, device=dev)
        wall = time.perf_counter() - t0
        n_launch = grid_cuda.LAUNCHES
        launches += n_launch
        log("main", f"recon_radial2d {mode}: out {out.shape} {out.dtype}, "
            f"kernel launches {n_launch}, host wall {wall:.3f} s (incl. transfers)")
        require(out.shape == (NZ, 1, NRO // 2, NRO // 2), f"{mode} shape {out.shape}")
        require(bool(np.isfinite(out).all()), f"{mode} output not finite")
        require(n_launch == NZ, f"{mode}: {n_launch} kernel launches, expected {NZ}")
        outs[mode] = out[:, 0]
    a = torch.from_numpy(outs["direct"]).reshape(NZ, -1)
    b = torch.from_numpy(outs["incremental"]).reshape(NZ, -1)
    worst = float((torch.linalg.vector_norm(b - a, dim=1) / torch.linalg.vector_norm(a, dim=1)).max())
    log("main", f"incremental vs direct worst-frame nrmse {worst:.3e} (tol {INC_TOL})")
    require(worst < INC_TOL, f"incremental vs direct {worst:.3e}")
    d3 = torch.from_numpy(np.ascontiguousarray(host[:, : work + 2 * SLIDE])).to(dev)
    plain3 = recon_frames(d3, dataclasses.replace(cfg, backend="jnp"), work, SLIDE, 3)
    for z in range(3):
        e = nrmse(outs["direct"][z], plain3[z].cpu())
        log("main", f"frame {z} kernel recon vs plain-gridder recon on the card: nrmse {e:.3e}")
        require(e <= KERNEL_TOL, f"frame {z} vs plain {e:.3e}")

    # -- 5 golden ------------------------------------------------------------
    g = np.load(os.path.join(ROOT, "tests", "data", "torch_port_golden.npz"))
    grng = np.random.default_rng(int(g["seed"]))
    shape = tuple(int(s) for s in g["shape"])
    gin = (grng.standard_normal(shape) + 1j * grng.standard_normal(shape)).astype(np.complex64)
    gcfg = ReconConfig(golden_angle=True, data_undersamp=float(g["undersamp"]),
                       prof_slide=int(g["slide"]), adjoint=True)
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

    require("jax" not in sys.modules, "JAX was imported")
    print(json.dumps({"kernels": [{
        "name": "grid_radial2d",
        "route": "cuda",
        "source": "tron_tpu_torch/csrc/grid_radial2d.cu",
        "replaces": "tron_tpu/ops/grid_pallas.py:933",
        "launches": launches,
        "max_abs_err": err512,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
