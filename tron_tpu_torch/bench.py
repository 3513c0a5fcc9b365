"""Headline benchmark of the port: golden-angle whole-body gridding
throughput on one card, and the twelve sections of the JAX package's
`bench.py` on tron_tpu_torch (its counterpart; `bench.py` times tron_tpu and
stays as it is).

    python -m tron_tpu_torch.bench [--device 0|cpu] [--smoke] [--stream-fixture PATH]

Reference (BASELINE.md): TRON reconstructs the whole-body series (nc 6, nro
512, -u 0.4 -d 21 -a -G: 956 frames of 256^2) in 3.28 s on the paper's GPU,
~183 Msamples/s of gridding throughput (nz*nc*nro*work coil-samples).  The
sections run in `bench.py`'s order on its whole-body geometry and data from
``numpy.random.default_rng(0)`` and report under its keys, so its
`BENCH_r0*.json` and this line read side by side; each section also
records the route its operators took (kernel or plain version), the
precision class, and the kernels' launches by name.

Timing: on data already on the device, each run ending in a scalar read
back; CUDA events after a synchronize (the host clock beside them, and alone
on the CPU); warm-ups first, then timed runs, the median reported as the
value and every run under ``<key>_all`` (``<key>_host_all`` by the host
clock).  A section that takes a slope reports both end points.

Each section runs once.  One that raises has its error recorded under
``errors`` and the others still run; the one JSON line is printed last
either way, and the exit code is 1 if ``errors`` is not empty.  Nothing is
retried, nothing run on the card is redone on the CPU, and no section
measures a smaller workload under its key.  The card is used unless
``--device cpu`` is given; a missing card is an error.  ``--smoke`` runs
every section at tiny shapes with the same code and keys.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
import types

import numpy as np
import torch

from tron_tpu_torch import cli
from tron_tpu_torch.config import AngleScheme, ReconConfig
from tron_tpu_torch.device import describe, parse_device, synchronize
from tron_tpu_torch.io import ra_query
from tron_tpu_torch.io.native import radial_dims
from tron_tpu_torch.nufft import _kernel_backend, kernel_class, nufft_adjoint, nufft_forward
from tron_tpu_torch.ops import degrid_cuda, grid_cuda
from tron_tpu_torch.ops.coil import coil_combine_sos, coil_combine_walsh_frames
from tron_tpu_torch.phantom import birdcage_sensitivities, shepp_logan
from tron_tpu_torch.recon import (
    _koosh_kz_ifft,
    _koosh_slice_block,
    _map_frames,
    recon_frames,
    recon_frames_incremental,
    recon_radial2d,
)
from tron_tpu_torch.solver import cgnr_radial2d
from tron_tpu_torch.tools import make_goldenangle
from tron_tpu_torch.tools.roofline import grid_bound
from tron_tpu_torch.trajectory import spoke_angles

METRIC = "gridding_throughput_whole_body"
UNIT = "Msamples/s/chip"
BASELINE_MSPS = 183.0  # the paper GPU's whole-body rate (BASELINE.md)
SEED = 0
INC_TOL = 1e-4  # incremental vs direct, worst frame NRMSE (bench.py:266)
GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "data", "torch_bench_golden.npz",
)


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The sizes of every section (``FULL``: `bench.py`'s)."""

    nc: int                   # whole-body series: coils,
    nro: int                  # readouts per spoke,
    slide: int                # spokes between frames,
    frames: int               # frames (sections 1-4, 6, 12)
    osf_frames: int           # frames of section 7
    kw3_frames: int           # frames of section 8
    koosh_nro: int            # section 5: readouts,
    koosh_npe2: tuple         # kz encodings at the two ends of the slope,
    koosh_e2e_npe2: int       # and of the end-to-end runs
    cgnr_pair_iters: tuple    # section 9: iterations at the ends of each slope
    cgnr_toeplitz_iters: tuple
    series: tuple             # section 10: nc, nro, npe1, slide (swallowing class)
    walsh_frames: tuple       # section 11: frames at the ends of the slope
    warmups: int
    runs: int                 # timed runs of every section
    runs_long: int            # timed runs of sections 10 and 12


FULL = Shapes(
    nc=6, nro=512, slide=21, frames=956, osf_frames=128, kw3_frames=128,
    koosh_nro=256, koosh_npe2=(16, 64), koosh_e2e_npe2=8,
    cgnr_pair_iters=(2, 34), cgnr_toeplitz_iters=(2, 258),
    series=(4, 256, 3000, 21), walsh_frames=(32, 192),
    warmups=2, runs=5, runs_long=3,
)
SMOKE = Shapes(
    nc=2, nro=64, slide=21, frames=3, osf_frames=2, kw3_frames=2,
    koosh_nro=32, koosh_npe2=(2, 4), koosh_e2e_npe2=2,
    cgnr_pair_iters=(2, 4), cgnr_toeplitz_iters=(2, 66),
    series=(2, 64, 74, 21), walsh_frames=(1, 5),
    warmups=1, runs=1, runs_long=1,
)


def whole_body_cfg(shapes: Shapes, **changes) -> ReconConfig:
    """`tron -a -G -u 0.4 -d <slide>` (`bench.py:170-173`), with ``changes``."""
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=shapes.slide,
                      adjoint=True)
    return dataclasses.replace(cfg, **changes)


def work_of(shapes: Shapes) -> int:
    """Spokes per whole-body frame (204 at full size)."""
    return whole_body_cfg(shapes).npe1work(shapes.nro, 10**9)


@dataclasses.dataclass
class FramesCase:
    """A sliding-window series on a device: (nc, npe1, nro) samples."""

    cfg: ReconConfig
    work: int
    slide: int
    nz: int
    data: torch.Tensor

    @property
    def samples(self) -> int:
        """Coil-samples gridded per series (`bench.py:200`)."""
        return self.nz * self.data.shape[0] * self.data.shape[-1] * self.work


def frames_case(shapes: Shapes, nz: int, device, **changes) -> FramesCase:
    """nz whole-body frames of ``default_rng(SEED)`` samples on ``device``."""
    work = work_of(shapes)
    shape = (shapes.nc, work + (nz - 1) * shapes.slide, shapes.nro)
    rng = np.random.default_rng(SEED)
    data = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return FramesCase(whole_body_cfg(shapes, **changes), work, shapes.slide, nz,
                      torch.from_numpy(data).to(device))


def direct_images(case: FramesCase) -> torch.Tensor:
    return recon_frames(case.data, case.cfg, case.work, case.slide, case.nz)


def incremental_images(case: FramesCase) -> torch.Tensor:
    return recon_frames_incremental(case.data, case.cfg, case.work, case.slide, case.nz)


def random_images(shape: tuple, device, seed: int) -> torch.Tensor:
    """Complex64 images made on ``device`` from a seeded ``torch.Generator``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.complex64)


def forward_frames(imgs: torch.Tensor, cfg: ReconConfig, work: int, nro: int) -> torch.Tensor:
    """Images (nz, nc, n, n) -> samples (nz, nc, work, nro) on the first
    ``work`` golden-angle spokes, frame by frame (`bench.py:469-475`)."""
    angles = spoke_angles(work, AngleScheme.GOLDEN, 0, device=imgs.device)
    return _map_frames(lambda z: nufft_forward(imgs[z], angles, cfg, nro=nro), imgs.shape[0])


def phantom_coils(n: int, nc: int, device) -> torch.Tensor:
    """Shepp-Logan times birdcage sensitivities, (nc, n, n) complex64."""
    return torch.from_numpy(shepp_logan(n)[None] * birdcage_sensitivities(n, nc)).to(device)


def accuracy_case(shapes: Shapes, device) -> tuple:
    """Section 3's frame: the whole-body phantom through the forward at
    float32 on the first frame's spokes: (cfg, angles, samples (nc, work,
    nro))."""
    cfg = whole_body_cfg(shapes)
    angles = spoke_angles(work_of(shapes), AngleScheme.GOLDEN, 0, device=device)
    img = phantom_coils(shapes.nro // 2, shapes.nc, device)
    data = nufft_forward(img, angles, dataclasses.replace(cfg, matmul_dtype="float32"),
                         nro=shapes.nro)
    return cfg, angles, data


def anchor_images(cfg: ReconConfig, angles: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The adjoint through the plain operators at float32: coil images."""
    return nufft_adjoint(
        data, angles, dataclasses.replace(cfg, backend="jnp", matmul_dtype="float32"))


def sos(coilimg: torch.Tensor) -> np.ndarray:
    """Sum-of-squares magnitude over the coil axis, float32 on the host."""
    return coil_combine_sos(coilimg).abs().cpu().numpy()


def nrmse(a, b) -> float:
    """||a - b|| / ||b|| on the tensors' device."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def checksum(x: torch.Tensor) -> float:
    """The scalar read back that ends a timed run."""
    return x.abs().sum().item()


class Bench:
    """One run of the sections on one device, writing into ``result``."""

    def __init__(self, shapes: Shapes, device: torch.device, result: dict,
                 stream_fixture: str | None = None):
        self.shapes, self.device, self.result = shapes, device, result
        self.stream_fixture = stream_fixture
        self.section = None

    # -- bookkeeping -------------------------------------------------------
    def uses(self, *cfgs: ReconConfig) -> None:
        """Record the route and precision classes of the operators of the
        running section: "kernel" where every config reaches the kernel
        wrappers with a CUDA tensor, "plain" otherwise."""
        on_card = self.device.type == "cuda"
        kernel = on_card and all(_kernel_backend(c, self.device) for c in cfgs)
        self.section["route"] = "kernel" if kernel else "plain"
        self.section["precision"] = list(dict.fromkeys(
            kernel_class(c, self.device) for c in cfgs))

    def run(self, name: str, fn) -> None:
        """Section ``name`` once; an error lands in ``result["errors"]``."""
        self.section = {"route": "plain", "precision": []}
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            fn(self)
        except Exception as e:  # a section's failure is recorded; the others still run
            self.result["errors"][name] = f"{type(e).__name__}: {e}"
            traceback.print_exc(file=sys.stderr)
        self.section["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
        self.section["wall_s"] = time.perf_counter() - t0
        self.result["sections"][name] = self.section
        print(f"[bench] {name}: {self.section['wall_s']:.2f} s, {self.section}",
              file=sys.stderr, flush=True)

    def time(self, fn, runs: int | None = None) -> tuple[list, list]:
        """``fn`` after the warm-ups, then ``runs`` timed runs: (seconds by
        CUDA events, or by the host clock on the CPU; seconds by the host
        clock).  ``fn`` must end in a read back."""
        runs = self.shapes.runs if runs is None else runs
        for _ in range(self.shapes.warmups):
            fn()
        cuda = self.device.type == "cuda"
        events, host = [], []
        for _ in range(runs):
            synchronize(self.device)
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
            if cuda:
                end.record()
                end.synchronize()
                events.append(start.elapsed_time(end) / 1e3)
        return (events if cuda else host), host

    def put(self, key: str, values: list, host: list | None = None) -> float:
        """The median of ``values`` under ``key``, every value under
        ``key_all`` and the host clock's under ``key_host_all``."""
        self.result[key] = statistics.median(values)
        self.result[key + "_all"] = values
        if host is not None:
            self.result[key + "_host_all"] = host
        return self.result[key]

    def put_rate(self, key: str, samples: int, secs: list, host: list) -> float:
        """Msamples/s of each run under ``key`` (see ``put``)."""
        return self.put(key, [samples / s / 1e6 for s in secs],
                        [samples / s / 1e6 for s in host])

    def slope(self, key: str, points: tuple, seconds_at) -> float:
        """Seconds per unit between the two ``points``: the median seconds
        at each end under ``key_s_lo`` / ``key_s_hi``, the points under
        ``key_points``; NaN where the slope is not positive."""
        lo, hi = points
        t_lo = self.put(key + "_s_lo", *seconds_at(lo))
        t_hi = self.put(key + "_s_hi", *seconds_at(hi))
        self.result[key + "_points"] = [lo, hi]
        per = (t_hi - t_lo) / (hi - lo)
        return per if per > 0 else float("nan")


def launch_counts() -> dict:
    return {**grid_cuda.LAUNCH_COUNTS, "degrid_radial2d": degrid_cuda.LAUNCHES}


# -- the sections, in bench.py's order ----------------------------------------

def throughput(b: Bench) -> None:
    """1: ``recon_frames`` on the whole-body series (`bench.py:203-222`)."""
    s, r = b.shapes, b.result
    case = frames_case(s, s.frames, b.device)
    b.uses(case.cfg)
    secs, host = b.time(lambda: checksum(direct_images(case)))
    msps = b.put_rate("value", case.samples, secs, host)
    r["vs_baseline"] = msps / BASELINE_MSPS
    r["frames_per_s"] = case.nz / statistics.median(secs)
    r["frames"] = case.nz
    b.put("seconds_per_run", secs, host)
    r["direct_msamples_per_s"] = msps
    r["headline_mode"] = "direct"
    nxos = int(s.nro // 2 * case.cfg.gridos)
    planes = grid_cuda.to_sample_planes(case.data[:, : case.work], nxos)
    angles = spoke_angles(case.work, AngleScheme.GOLDEN, 0, device=b.device)
    r["direct_bound_ms"], r["direct_bound_by"] = grid_bound(planes, angles, nxos)
    r["direct_roofline_pct"] = 100 * r["direct_bound_ms"] / (1e3 * r["seconds_per_run"] / case.nz)


def incremental(b: Bench) -> None:
    """2: ``recon_frames_incremental``; it takes the headline only if faster
    and its worst frame is within INC_TOL of direct (`bench.py:224-278`)."""
    r = b.result
    case = frames_case(b.shapes, b.shapes.frames, b.device)
    b.uses(case.cfg)
    secs, host = b.time(lambda: checksum(incremental_images(case)))
    msps = b.put_rate("incremental_msamples_per_s", case.samples, secs, host)
    direct, inc = direct_images(case), incremental_images(case)
    num = torch.linalg.vector_norm((inc - direct).reshape(case.nz, -1), dim=1)
    den = torch.linalg.vector_norm(direct.reshape(case.nz, -1), dim=1)
    worst = float(torch.max(num / den))
    r["nrmse_incremental_vs_direct"] = worst
    if worst < INC_TOL and r.get("value") is not None and msps > r["value"]:
        r["value"], r["value_all"], r["value_host_all"] = (
            msps, r["incremental_msamples_per_s_all"], r["incremental_msamples_per_s_host_all"])
        r["vs_baseline"] = msps / BASELINE_MSPS
        r["frames_per_s"] = case.nz / statistics.median(secs)
        r["frames"] = case.nz
        b.put("seconds_per_run", secs, host)
        r["headline_mode"] = "incremental"


def accuracy(b: Bench) -> None:
    """3: one whole-body phantom frame at bfloat16 and bf16x3 against the
    plain operators at float32 (`bench.py:280-314`), and the float32 anchor
    against JAX's (``GOLDEN``) where the shapes are whole-body's."""
    cfg, angles, data = accuracy_case(b.shapes, b.device)
    accurate = dataclasses.replace(cfg, matmul_dtype="bf16x3")
    b.uses(cfg, accurate)
    anchor = anchor_images(cfg, angles, data)
    r = b.result
    r["nrmse_bf16_vs_fp32"] = nrmse(nufft_adjoint(data, angles, cfg), anchor)
    r["nrmse_accurate_vs_fp32"] = nrmse(nufft_adjoint(data, angles, accurate), anchor)
    g = np.load(GOLDEN)
    whole_body = (b.shapes.nc, b.shapes.nro) == (int(g["nc"]), int(g["nro"]))
    r["nrmse_fp32_vs_jax_golden"] = nrmse(sos(anchor), g["images"]) if whole_body else None


def accurate_throughput(b: Bench) -> None:
    """4: section 1 at bf16x3 (`--precision accurate`, `bench.py:316-350`)."""
    case = frames_case(b.shapes, b.shapes.frames, b.device, matmul_dtype="bf16x3")
    b.uses(case.cfg)
    secs, host = b.time(lambda: checksum(direct_images(case)))
    b.put_rate("accurate_msamples_per_s", case.samples, secs, host)
    b.result["accurate_frames"] = case.nz


def koosh(b: Bench) -> None:
    """5: `-3`. The device rate is the slope between two kz depths of the kz
    transform and the slice recons on device-resident data; the end-to-end
    rate is ``recon_radial2d`` from the host, also with the float16
    readback (`bench.py:352-446`)."""
    s = b.shapes
    nro = s.koosh_nro
    cfg_k = whole_body_cfg(s, koosh=True, prof_slide=0, data_undersamp=1.0)
    cfg2 = dataclasses.replace(cfg_k, koosh=False)
    work = cfg_k.npe1work(nro, 10**9)
    b.uses(cfg2)
    rng = np.random.default_rng(SEED)

    def stack(npe2):
        shape = (s.nc, 1, nro, work, npe2)
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    def seconds_at(npe2):
        d5 = torch.from_numpy(stack(npe2)).to(b.device)
        return b.time(lambda: checksum(
            _koosh_slice_block(_koosh_kz_ifft(d5), 0, npe2, cfg2, work, work, 1)))

    b.result["koosh_slices_per_s"] = 1.0 / b.slope("koosh", s.koosh_npe2, seconds_at)
    dk = stack(s.koosh_e2e_npe2)
    for key, half in (("koosh_slices_per_s_e2e", False), ("koosh_slices_per_s_e2e_half", True)):
        secs, host = b.time(lambda half=half: recon_radial2d(dk, cfg_k, half, device=b.device))
        b.put(key, [dk.shape[-1] / t for t in secs], [dk.shape[-1] / t for t in host])


def degrid(b: Bench) -> None:
    """6: ``nufft_forward`` of the whole-body series' frames of 6-coil 256^2
    images made on the device (`bench.py:448-496`)."""
    s = b.shapes
    cfg, work, n = whole_body_cfg(s), work_of(s), s.nro // 2
    b.uses(cfg)
    imgs = random_images((s.frames, s.nc, n, n), b.device, SEED)
    secs, host = b.time(lambda: checksum(forward_frames(imgs, cfg, work, s.nro)))
    b.put_rate("degrid_msamples_per_s", s.frames * s.nc * s.nro * work, secs, host)
    b.result["degrid_frames"] = s.frames


def osf(b: Bench) -> None:
    """7: the adjoint and the forward at grid oversampling 1.5 and 2.5
    (`bench.py:498-565`)."""
    s = b.shapes
    cfgs = [whole_body_cfg(s, gridos=o) for o in (1.5, 2.5)]
    b.uses(*cfgs)
    n, nz = s.nro // 2, s.osf_frames
    for cfg in cfgs:
        tag = str(cfg.gridos).replace(".", "")
        case = frames_case(s, nz, b.device, gridos=cfg.gridos)
        secs, host = b.time(lambda: checksum(direct_images(case)))
        b.put_rate(f"adjoint_msamples_per_s_osf{tag}", case.samples, secs, host)
        del case
        imgs = random_images((nz, s.nc, n, n), b.device, int(cfg.gridos * 10))
        secs, host = b.time(lambda: checksum(forward_frames(imgs, cfg, work_of(s), s.nro)))
        b.put_rate(f"degrid_msamples_per_s_osf{tag}", nz * s.nc * s.nro * work_of(s), secs, host)


def kw3(b: Bench) -> None:
    """8: the adjoint at kernel width 3 (`bench.py:567-597`)."""
    case = frames_case(b.shapes, b.shapes.kw3_frames, b.device, kernwidth=3.0)
    b.uses(case.cfg)
    secs, host = b.time(lambda: checksum(direct_images(case)))
    b.put_rate("adjoint_msamples_per_s_kw3", case.samples, secs, host)


def cgnr_cost(b: Bench) -> None:
    """9: CGNR seconds per iteration on one whole-body frame, the degrid/grid
    pair and Toeplitz, each the slope between two forced iteration counts
    (``rtol=0``; `bench.py:599-645`)."""
    s = b.shapes
    work, cfg = work_of(s), whole_body_cfg(s)
    b.uses(cfg)
    rng = np.random.default_rng(SEED)
    shape = (s.nc, work, s.nro)
    data = torch.from_numpy(
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ).to(b.device)
    angles = spoke_angles(work, AngleScheme.GOLDEN, 0, device=b.device)
    for name, toeplitz, points in (("pair", False, s.cgnr_pair_iters),
                                   ("toeplitz", True, s.cgnr_toeplitz_iters)):
        def seconds_at(niter, toeplitz=toeplitz):
            c = dataclasses.replace(cfg, niter=niter, toeplitz=toeplitz)
            return b.time(lambda: checksum(cgnr_radial2d(data, angles, c, rtol=0.0)))

        b.result[f"cgnr_{name}_s_per_iter"] = b.slope(f"cgnr_{name}", points, seconds_at)


def series_case(shapes: Shapes, device) -> tuple:
    """Section 10's swallowing-class series from the phantom: (cfg, work,
    slide, nz, data (nc, npe1, nro) on ``device``, truth (n, n))."""
    nc, nro, npe1, slide = shapes.series
    cfg = whole_body_cfg(shapes, data_undersamp=0.5, prof_slide=slide)
    work = cfg.npe1work(nro, npe1)
    nz = 1 + (npe1 - work) // slide
    angles = spoke_angles(npe1, AngleScheme.GOLDEN, 0, device=device)
    data = nufft_forward(phantom_coils(nro // 2, nc, device), angles,
                         dataclasses.replace(cfg, matmul_dtype="float32"), nro=nro)
    return cfg, work, slide, nz, data, shepp_logan(nro // 2)


def nrmse_truth(frames: np.ndarray, truth: np.ndarray) -> float:
    """Best-scale magnitude NRMSE against the phantom, mean over frames
    (`bench.py:680-690`)."""
    tmag = np.abs(truth)
    errs = []
    for f in np.abs(frames):
        a = float(np.vdot(f, tmag).real / max(np.vdot(f, f).real, 1e-30))
        errs.append(float(np.linalg.norm(a * f - tmag) / np.linalg.norm(tmag)))
    return float(np.mean(errs))


def cgnr_series(b: Bench) -> None:
    """10: the swallowing-class series three ways: the adjoint, CGNR `-i 10`
    on the pair, CGNR `-i 10 --toeplitz`; wall time and NRMSE against the
    phantom (`bench.py:647-724`)."""
    cfg, work, slide, nz, data, truth = series_case(b.shapes, b.device)
    modes = (("adjoint", cfg), ("pair", dataclasses.replace(cfg, niter=10)),
             ("toeplitz", dataclasses.replace(cfg, niter=10, toeplitz=True)))
    b.uses(*(c for _, c in modes))
    for name, c in modes:
        out = None

        def run(c=c):
            nonlocal out
            out = recon_frames(data, c, work, slide, nz)
            return checksum(out)

        secs, host = b.time(run, b.shapes.runs_long)
        b.put(f"cgnr_series_{name}_wall_s", secs, host)
        b.result[f"cgnr_series_{name}_nrmse_truth"] = nrmse_truth(out.cpu().numpy(), truth)
    b.result["cgnr_series_frames"] = nz


def walsh_cost(b: Bench) -> None:
    """11: Walsh's adaptive combine, ms per frame of 6-coil 256^2 images as
    the slope between two frame counts (`bench.py:726-769`)."""
    s = b.shapes
    n = s.nro // 2

    def seconds_at(nf):
        imgs = random_images((nf, s.nc, n, n), b.device, nf)
        return b.time(lambda: checksum(coil_combine_walsh_frames(imgs, 1)))

    b.result["walsh_ms_per_frame"] = 1e3 * b.slope("walsh", s.walsh_frames, seconds_at)


def stream_wall(b: Bench) -> None:
    """12: `tron-torch -a -G -u 0.4 -d 21 --stream --half` file to file, and
    with `--compress 3`, in turns, host wall (`bench.py:771-830`).  The
    fixture is ``--stream-fixture`` or one that `tools.make_goldenangle`
    writes; its frame count is read from its header."""
    s, r = b.shapes, b.result
    cfg = whole_body_cfg(s)
    b.uses(cfg)
    rank = types.SimpleNamespace(rank=0, world=1, device=b.device)
    with tempfile.TemporaryDirectory() as tmp:
        fixture = b.stream_fixture
        if fixture is None:
            fixture = os.path.join(tmp, "whole_body.ra")
            argv = ["--nc", str(s.nc), "--nro", str(s.nro),
                    "--npe", str(work_of(s) + (s.frames - 1) * s.slide)]
            r["stream_fixture_built"] = "tools.make_goldenangle " + " ".join(argv)
            with contextlib.redirect_stdout(sys.stderr):
                dev = "cpu" if b.device.type == "cpu" else str(b.device.index or 0)
                make_goldenangle.main([fixture, *argv, "--device", dev])
        _, _, nro, npe1, _, _ = radial_dims(ra_query(fixture))
        r["stream_frames"] = cfg.frame_geometry(nro, npe1)[2]
        r["stream_fixture"] = os.path.basename(fixture)
        args = ["-a", "-G", "-u", "0.4", "-d", str(s.slide), "--stream", "--half", fixture,
                os.path.join(tmp, "img.ra")]
        walls = {"": [], "--compress 3": []}
        for i in range(s.warmups + s.runs_long):
            for extra, acc in walls.items():
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(sys.stderr):
                    rc = cli.main(args[:-2] + extra.split() + args[-2:], _rank=rank)
                if rc != 0:
                    raise RuntimeError(f"tron-torch {' '.join(args)} {extra}: exit {rc}")
                if i >= s.warmups:
                    acc.append(time.perf_counter() - t0)
    b.put("stream_wall_s", walls[""])
    b.put("stream_wall_compress3_s", walls["--compress 3"])


SECTIONS = (
    ("throughput", throughput),
    ("incremental", incremental),
    ("accuracy", accuracy),
    ("accurate_throughput", accurate_throughput),
    ("koosh", koosh),
    ("degrid", degrid),
    ("osf", osf),
    ("kw3", kw3),
    ("cgnr_cost", cgnr_cost),
    ("cgnr_series", cgnr_series),
    ("walsh_cost", walsh_cost),
    ("stream_wall", stream_wall),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="0", help="CUDA device index, or 'cpu'")
    p.add_argument("--smoke", action="store_true",
                   help="every section at tiny shapes, one warm-up and one run")
    p.add_argument("--stream-fixture", help="whole-body .ra for section 12 (default: built)")
    args = p.parse_args(argv)

    shapes = SMOKE if args.smoke else FULL
    result = {"metric": METRIC, "value": None, "unit": UNIT, "vs_baseline": None,
              "mode": "smoke" if args.smoke else "full", "errors": {}, "sections": {}}
    try:
        device = parse_device(args.device)
    except (RuntimeError, ValueError) as e:
        result["errors"]["device"] = f"{type(e).__name__}: {e}"
    else:
        name, power = describe(device)
        result.update(platform="gpu" if device.type == "cuda" else "cpu", device=name,
                      power_limit=power, torch=torch.__version__, cuda=torch.version.cuda)
        if device.type == "cuda":  # the float32 anchor and plain versions stay float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        bench = Bench(shapes, device, result, args.stream_fixture)
        for name, fn in SECTIONS:
            bench.run(name, fn)
    print(json.dumps(result), flush=True)
    return 1 if result["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
