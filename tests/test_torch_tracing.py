"""The port's spans (`tron_tpu_torch/tracing.py`): where `recon_radial2d`
records them under a profiler, in what order and how many, and that with
no profiler they cost the recon nothing but a check and change no bit of
its images.  On the CPU at a tiny geometry: 2 coils, 64 readouts, 74
spokes, frames of 25 spokes sliding by 21, so 3 frames."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from tron_tpu_torch import recon, tracing
from tron_tpu_torch.config import KernelTuning, ReconConfig
from tron_tpu_torch.ops import grid_cuda

NC, NRO, NPE1, NZ = 2, 64, 74, 3
METRICS = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
CASES = {"direct": ({}, 1), "incremental": ({"incremental": True}, 1), "nt2": ({}, 2)}
TOP = ("tron.relayout", "tron.upload", "tron.prep", "tron.frame", "tron.readback")


def _cfg(**kw) -> ReconConfig:
    return ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21, **kw)


def _input(nt: int) -> np.ndarray:
    x = np.random.default_rng(18 + nt).standard_normal((2, NC, nt, NRO, NPE1), np.float32)
    return (x[0] + 1j * x[1]).astype(np.complex64)


def _profiled(fn):
    """fn() under a CPU profiler -> (its result, the tron.* spans as sorted
    (start, end, name), times in us)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("tron."))
    return out, spans


def _recon(case: str):
    kw, nt = CASES[case]
    indata, cfg = _input(nt), _cfg(**kw)
    assert cfg.frame_geometry(NRO, NPE1) == (25, 21, NZ)
    return lambda: recon.recon_radial2d(indata, cfg, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_recon_records_its_spans_in_order(case):
    nt = CASES[case][1]
    out, spans = _profiled(_recon(case))
    assert out.shape == (NZ, nt, NRO // 2, NRO // 2)
    assert {n for _, _, n in spans} <= set(tracing.SPANS)
    by = {name: [(s, e) for s, e, n in spans if n == name] for name in tracing.SPANS}
    assert [len(by[n]) for n in TOP] == [1, 1, nt, nt * NZ, 1]
    # relayout < upload < (prep < that repetition's frames) per repetition < readback
    order = [by["tron.relayout"][0], by["tron.upload"][0]]
    for t in range(nt):
        order += [by["tron.prep"][t]] + by["tron.frame"][t * NZ:(t + 1) * NZ]
    order.append(by["tron.readback"][0])
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:])), order
    # each frame holds exactly one gridding wrapper call, and every call is in a frame
    grids = by["tron.grid_radial2d"]
    assert len(grids) == nt * NZ
    for s, e in by["tron.frame"]:
        assert sum(s <= gs and ge <= e for gs, ge in grids) == 1


@pytest.mark.parametrize("case", list(CASES))
def test_spans_off_enter_no_record_function(monkeypatch, case):
    """With no profiler a span is the one shared null context: no
    record_function is entered, and the images are bitwise those of a
    profiled run."""
    run = _recon(case)
    want, spans = _profiled(run)
    assert spans

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("tron.frame") is tracing.span("tron.prep")
    np.testing.assert_array_equal(run(), want)


@pytest.mark.parametrize("windowed,batched", [(True, False), (True, True), (False, False)])
def test_gridding_wrapper_span_names_its_kernel(windowed, batched):
    """One span per wrapper call, named after the kernel the call is
    routed to; on the CPU its plain version runs inside it."""
    name = ("grid_radial2d_batched" if batched else "grid_radial2d") if windowed \
        else "grid_seg_radial2d"
    g = torch.Generator().manual_seed(3)
    planes = torch.randn((12, 256, 4), generator=g)
    angles = torch.rand(12, generator=g) * 3.14
    out, spans = _profiled(lambda: grid_cuda.grid_radial2d_planes(
        planes, angles, 256, 2.0, 13.9, windowed=windowed, tuning=KernelTuning(batched=batched)))
    assert out.shape == (2, 256, 256)
    assert [n for _, _, n in spans] == [f"tron.{name}"]


def test_every_kernel_has_its_span():
    assert {f"tron.{k}" for k in grid_cuda.KERNELS} | {"tron.degrid_radial2d"} <= set(tracing.SPANS)
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)
    assert all(n.startswith("tron.") for n in tracing.SPANS)


def test_benchmark_readers_match_recorded_spans():
    """Every span name the benchmark's per-layer readers match is one the
    port records."""
    names = set()
    for path in sorted(METRICS.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and node.value.startswith("tron."):
                names.add(node.value)
    assert {"tron.relayout", "tron.upload", "tron.readback", "tron.frame",
            "tron.grid_radial2d"} <= names
    assert names <= set(tracing.SPANS)
