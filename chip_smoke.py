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
  8 degrid   the CUDA degridding kernel vs its plain torch version (wrap and
             clip; nxos 64-640, 1-10 coils, gridos 1.5/2/2.5, an odd nro)
  9 exact    the gridding kernel's exact lattice vs the plain raw-rows gridder
 10 dot      dot test of the kernel pair at gridos 1.5, 2, 2.5
 11 forward  forward recon_radial2d at full width (32 frames of 6-coil 256^2,
             -G -u 1: 512 spokes of 512 readouts), with launch counts
 12 cgnr     -a -G -u 0.4 -d 21 -i 10 on the whole-body series, with launch
             counts, vs plain-operator CGNR; --toeplitz on 8 frames
 13 solver   6-coil birdcage Shepp-Logan 256^2: CGNR beats the adjoint and
             its data residual falls
 14 cli2     tron-torch forward and -i 4 on .ra fixtures
 15 timing2  degrid kernel vs plain ms, forward Msamples/s, CGNR ms per frame
Then the kernel table as one JSON line, the nvidia-smi line, and the result
line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
CG_TOL = 1e-4                         # CGNR, kernels vs plain operators (tests/test_torch_solver.py)
DOT_TOL = 1e-4                        # pair dot test (tests/test_grid_pallas.py:419)
NITER = 10                            # CGNR iterations of the main path (-i 10)
NF = 32                               # forward frames
CG_WALL = 120.0                       # s; above it the CGNR path takes the first 128 frames


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
    # one line per kernel instantiation: name<channel block[, row lattice]>,
    # from ptxas's "Compiling entry function", spill and register lines
    ptxas, name, spill = [], None, ""
    for ln in built.log.splitlines():
        m = re.search(r"((?:de)?grid_radial2d_kernel)ILi(\d+)E(?:Lb([01])E)?", ln)
        if "Compiling entry function" in ln and m:
            lattice = "" if m.group(3) is None else (", lattice" if m.group(3) == "1" else ", integer")
            name = f"{m.group(1)}<{m.group(2)}{lattice}>"
        elif name and "spill stores" in ln:
            spill = ln.strip()
        elif name and "registers" in ln:
            regs = re.search(r"Used \d+ registers", ln)
            ptxas.append(f"{name}: {regs.group(0) if regs else ln.strip()}; {spill}")
            name, spill = None, ""
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

    log("timing", f"whole-body gridding kernel {kern_ms:.4f} ms per frame; PERF.md records "
        "0.711 ms for it on the same card class before the exact lattice was added")

    # -- 8 degrid kernel vs plain ---------------------------------------------
    from tron_tpu_torch.ops import degrid_cuda
    from tron_tpu_torch.ops.degrid import degrid_radial2d as degrid_plain

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
    ]
    derr512 = None
    for name, n, C, npe, nro, gos in dcases:
        b = kb_beta(kw, gos)
        g = cgrid(C, n, n)
        ang = spoke_angles(npe, "golden", 19000, device=dev)
        for wrap in (True, False):
            got = degrid_cuda.degrid_radial2d(g, ang, nro, kw, b, wrap=wrap)
            want = degrid_plain(g, ang, nro, kw, b, wrap=wrap)
            torch.cuda.synchronize()
            e = nrmse(got, want)
            mae = float((got - want).abs().max())
            log("degrid", f"{name} {'wrap' if wrap else 'clip'}: nrmse {e:.3e} "
                f"max_abs_err {mae:.3e} (tol {KERNEL_TOL})")
            require(e <= KERNEL_TOL, f"degrid vs plain {name} wrap={wrap}: nrmse {e:.3e}")
            if name == "nxos512 C6 npe204" and not wrap:
                derr512 = mae
                again = degrid_cuda.degrid_radial2d(g, ang, nro, kw, b, wrap=wrap)
                require(torch.equal(got, again), "repeat degrid run is not bitwise equal")
                log("degrid", "nxos512 C6 npe204 clip: repeat run bitwise equal")

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

    # -- 11 forward main path ------------------------------------------------
    from tron_tpu_torch.nufft import nufft_adjoint, nufft_forward

    n_img = NRO // 2
    fimgs = (rng.standard_normal((NC, 1, n_img, n_img, NF), dtype=np.float32)
             + 1j * rng.standard_normal((NC, 1, n_img, n_img, NF), dtype=np.float32)
             ).astype(np.complex64)
    fcfg = ReconConfig(golden_angle=True, data_undersamp=1.0)
    grid_cuda.LAUNCHES = 0
    degrid_cuda.LAUNCHES = 0
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

    # -- 12 CGNR main path ---------------------------------------------------
    ccfg = dataclasses.replace(cfg, niter=NITER)
    probe = np.ascontiguousarray(indata[..., : work + 7 * SLIDE])
    t0 = time.perf_counter()
    recon_radial2d(probe, ccfg, device=dev)
    per_frame = (time.perf_counter() - t0) / 8
    nzc = NZ if per_frame * NZ <= CG_WALL else 128
    why = ("the whole series" if nzc == NZ else
           f"the first 128 frames: the series would take {per_frame * NZ:.0f} s > {CG_WALL:.0f} s")
    log("cgnr", f"8-frame probe {per_frame * 1e3:.1f} ms per frame; running {why}")
    cin = indata if nzc == NZ else np.ascontiguousarray(indata[..., : work + (nzc - 1) * SLIDE])
    grid_cuda.LAUNCHES = 0
    degrid_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    cout = recon_radial2d(cin, ccfg, device=dev)
    wall = time.perf_counter() - t0
    cg_grid, cg_degrid = grid_cuda.LAUNCHES, degrid_cuda.LAUNCHES
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
    grid_cuda.LAUNCHES = 0
    degrid_cuda.LAUNCHES = 0
    tout = recon_radial2d(probe, tcfg, device=dev)
    log("cgnr", f"--toeplitz on 8 frames: out {tout.shape}, grid launches "
        f"{grid_cuda.LAUNCHES}, degrid launches {degrid_cuda.LAUNCHES}; vs pair-mode CGNR "
        f"frames 0-7: nrmse {nrmse(tout[:, 0], cout[:8, 0]):.3e} (NUFFT-level, not a bound)")
    require(tout.shape == (8, 1, n_img, n_img), f"toeplitz shape {tout.shape}")
    require(bool(np.isfinite(tout).all()), "toeplitz output not finite")
    require(grid_cuda.LAUNCHES == 16 and degrid_cuda.LAUNCHES == 0,
            "toeplitz: expected 2 grid launches (kernel, right side) per frame, no degrid")

    # -- 13 solver sanity on the phantom -------------------------------------
    from tron_tpu_torch.metrics import lmse
    from tron_tpu_torch.phantom import birdcage_sensitivities, shepp_logan
    from tron_tpu_torch.solver import cgnr_radial2d

    ph = birdcage_sensitivities(n_img, NC) * shepp_logan(n_img)[None]
    pimg = torch.from_numpy(ph).to(dev)
    scfg = ReconConfig(golden_angle=True)
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
    log("timing2", f"degridding one CGNR frame ({NC}x{NRO}x{NRO} -> {NC}x{work}x{NRO}, clip): kernel "
        f"{dkern_ms:.4f} ms, plain {dplain_ms:.4f} ms (plain,kernel,kernel,plain: "
        f"{[round(1e3 * t, 4) for t in td_plain[:1] + td_kern + td_plain[1:]]}) on {card}")

    def forward_all():
        for z in range(NF):
            nufft_forward(fd[z], fang, fcfg, nro=NRO)

    s = timed(forward_all, 3)
    log("timing2", f"forward: {NF} frames in {s:.4f} s = {NF * NC * NRO * NRO / s / 1e6:.1f} "
        f"Msamples/s (nz*nc*npe1*nro / s) on {card}")
    nzt = min(32, NZ)
    dcg = dfull[:, : work + (nzt - 1) * SLIDE]
    s = timed(lambda: recon_frames(dcg, ccfg, work, SLIDE, nzt), 1)
    log("timing2", f"CGNR -i {NITER}: {1e3 * s / nzt:.3f} ms per frame ({nzt} frames, host "
        f"stop test each iteration) on {card}")

    require("jax" not in sys.modules, "JAX was imported")
    print(json.dumps({"kernels": [
        {
            "name": "grid_radial2d",
            "route": "cuda",
            "source": "tron_tpu_torch/csrc/grid_radial2d.cu",
            "replaces": "tron_tpu/ops/grid_pallas.py:933",
            "launches": launches + cg_grid,
            "max_abs_err": err512,
            "ms": kern_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "degrid_radial2d",
            "route": "cuda",
            "source": "tron_tpu_torch/csrc/degrid_radial2d.cu",
            "replaces": "tron_tpu/ops/degrid_pallas.py:44",
            "launches": fwd_launches + cg_degrid,
            "max_abs_err": derr512,
            "ms": dkern_ms,
            "plain_ms": dplain_ms,
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
