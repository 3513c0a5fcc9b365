"""Dissect the incremental headline run into delta gridding, epilogue and
loop overhead (counterpart of `scripts/inc_dissect.py`).

    DISSECT_FRAMES=956 DISSECT_NRO=512 python -m tron_tpu_torch.tools.inc_dissect [--device 0|cpu]

The incremental scheduler on the whole-body geometry (6 coils, -u 0.4,
slide 21; DISSECT_FRAMES frames, default 956, of DISSECT_NRO readouts,
default 512; data from `numpy.random.default_rng(0)`).  Three measurements
split its wall:

  full       `recon.recon_frames_incremental`, as the recon runs it
  grid_only  the same telescoping loop (`recon.incremental_scan`) with the
             per-frame epilogue replaced by a checksum of one row of the
             carried k-space grid: delta gridding plus the loop's overhead
  epi_only   the per-frame epilogue (`nufft._adjoint_epilogue`) and the SoS
             combine over nz scaled copies of one grid, no gridding

full - grid_only is about the epilogue's share.  The JAX script's epilogue
A/B (`epi_highest`, `epi_x3`, `x3_vs_highest_nrmse`) times its MXU DFT
sandwich, which the port replaces by `torch.fft` (not ported), so it has no
counterpart here.  `--device cpu` runs on the host, as the JAX script's
DISSECT_INTERPRET=1 does.  Each measurement: a first call, a warm one, then
the mean of 3 calls on the host clock read after a synchronise, with CUDA
events beside it.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.device import describe, parse_device, synchronize
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.nufft import _adjoint_epilogue, kernel_class, sdc_weights
from tron_tpu_torch.ops import grid_cuda
from tron_tpu_torch.ops.coil import coil_combine_sos
from tron_tpu_torch.recon import incremental_scan, recon_frames_incremental
from tron_tpu_torch.trajectory import spoke_angles

NC, SLIDE = 6, 21


@dataclasses.dataclass(frozen=True)
class Case:
    cfg: ReconConfig
    work: int
    nz: int
    data: torch.Tensor   # (nc, npe1, nro) complex64
    kgrid: torch.Tensor  # (nc, nxos, nxos) complex64, epi_only's grid

    @property
    def nxos(self) -> int:
        return int((self.data.shape[-1] // 2) * self.cfg.gridos)

    @property
    def beta(self) -> float:
        return kb_beta(self.cfg.kernwidth, self.cfg.gridos, self.cfg.beatty)


def make_case(nframes: int, nro: int, device: torch.device) -> Case:
    """The seeded whole-body-geometry inputs of ``nframes`` frames."""
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=SLIDE, adjoint=True)
    work = cfg.npe1work(nro, 10**9)
    nxos = int((nro // 2) * cfg.gridos)
    rng = np.random.default_rng(0)
    npe1 = work + (nframes - 1) * SLIDE
    data = (
        rng.standard_normal((NC, npe1, nro)) + 1j * rng.standard_normal((NC, npe1, nro))
    ).astype(np.complex64)
    kg = (
        rng.standard_normal((NC, nxos, nxos)) + 1j * rng.standard_normal((NC, nxos, nxos))
    ).astype(np.complex64)
    return Case(cfg, work, nframes, torch.from_numpy(data).to(device),
                torch.from_numpy(kg).to(device))


def full(case: Case, s: float = 1.0) -> torch.Tensor:
    """The production path: (nz, n, n) images."""
    return recon_frames_incremental(case.data * s, case.cfg, case.work, SLIDE, case.nz)


def grid_only(case: Case, s: float = 1.0) -> torch.Tensor:
    """The telescoping loop with a checksum epilogue: (nz,) sums of |row 0|
    of the carried grid (`scripts/inc_dissect.py:135-138`), which keep the
    carry live without an O(nxos^2) reduction per frame."""
    cfg, nxos = case.cfg, case.nxos
    dd = case.data * s
    w = sdc_weights(cfg, dd.shape[-1], case.work, dd.device).to(dd.dtype)
    src = grid_cuda.to_sample_planes(dd * w, nxos)
    scheme = cfg.scheme_for("adjoint")
    tuning = cfg.kernel_tuning()
    mm_class = kernel_class(cfg, dd.device)

    def window(pe0, m):
        return src.narrow(0, pe0, m)

    def angles_of(pe0, m):
        return spoke_angles(m, scheme, pe0, device=dd.device)

    def gridw(win, angles):
        return grid_cuda.grid_radial2d_planes(
            win, angles, nxos, cfg.kernwidth, case.beta, matmul_dtype=mm_class, tuning=tuning,
        )

    def frame_image(kg):
        return kg[..., 0, :].abs().sum()

    return incremental_scan(window, angles_of, gridw, frame_image, case.work, SLIDE, case.nz)


def epi_only(case: Case, s: float = 1.0) -> torch.Tensor:
    """The epilogue and SoS combine of nz frames, summed to a scalar."""
    n = case.data.shape[-1] // 2
    acc = torch.zeros((), device=case.kgrid.device)
    for z in range(case.nz):
        img = _adjoint_epilogue(case.kgrid * (s + 1e-6 * z), n, case.cfg, case.beta)
        acc += coil_combine_sos(img, axis=0).abs().sum()
    return acc


def _timeit(run, device: torch.device, tag: str, reps: int = 3) -> tuple[float, float | None]:
    """(host-clock s, CUDA-event s or None) per call of run, the mean of reps
    calls after a first and a warm one."""
    t = time.perf_counter()
    run(1.0)
    print(f"[dissect] {tag}: first call {time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    run(1.0001)
    synchronize(device)
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for i in range(reps):
        run(1.0 + 0.0001 * i)
    synchronize(device)
    dt = (time.perf_counter() - t0) / reps
    event_s = None
    if device.type == "cuda":
        end.record()
        end.synchronize()
        event_s = start.elapsed_time(end) / reps / 1e3
    print(f"[dissect] {tag}: {dt:.6f} s", file=sys.stderr, flush=True)
    return dt, event_s


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="0", help="CUDA device index, or 'cpu'")
    args = p.parse_args(argv)
    device = parse_device(args.device)
    nframes = int(os.environ.get("DISSECT_FRAMES", "956"))
    nro = int(os.environ.get("DISSECT_NRO", "512"))

    card, power = describe(device)
    case = make_case(nframes, nro, device)
    out = {"frames": case.nz, "device": card, "power_limit": power}
    samples = case.nz * NC * nro * case.work
    runs = {
        "full": lambda s: full(case, s).abs().sum().item(),
        "grid_only": lambda s: grid_only(case, s).sum().item(),
        "epi_only": lambda s: epi_only(case, s).item(),
    }
    for tag, run in runs.items():
        out[f"{tag}_s"], out[f"{tag}_event_s"] = _timeit(run, device, tag)
    out["full_msps"] = samples / out["full_s"] / 1e6
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
