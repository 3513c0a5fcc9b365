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
    # upload < relayout (the permute on the device) < (prep < that
    # repetition's frames) per repetition < readback
    order = [by["tron.upload"][0], by["tron.relayout"][0]]
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


def test_every_span_the_port_opens_is_listed():
    """Each ``span("tron.…")`` in the port's sources names one of SPANS,
    the frame graph's capture among them, and every listed name is
    opened somewhere (the kernels' by ``grid_cuda._SPANS``)."""
    port = Path(tracing.__file__).resolve().parent
    opened = set()
    for path in sorted(port.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span" \
                    and node.args and isinstance(node.args[0], ast.Constant):
                opened.add(node.args[0].value)
    assert "tron.frame_graph" in opened
    assert opened <= set(tracing.SPANS)
    assert set(tracing.SPANS) - opened == set(grid_cuda._SPANS.values())


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


CGNR = ("tron.cgnr", "tron.cgnr_rhs", "tron.cgnr_iter")
HALF = ("tron.angles", "tron.combine")


def _frame_half(by: dict) -> None:
    """A CGNR frame's scheduler half: each `tron.frame` holds one
    `tron.angles`, its `tron.cgnr` and one `tron.combine`, in that order
    and apart."""
    frames = by["tron.frame"]
    assert len(by["tron.angles"]) == len(by["tron.cgnr"]) == len(by["tron.combine"]) \
        == len(frames) == NZ
    for (fs, fe), a, c, m in zip(frames, by["tron.angles"], by["tron.cgnr"],
                                 by["tron.combine"]):
        assert fs <= a[0] and a[1] <= c[0] and c[1] <= m[0] and m[1] <= fe, (a, c, m)


def _cgnr_recon(niter: int):
    indata, cfg = _input(1), _cfg(niter=niter)
    return lambda: recon.recon_radial2d(indata, cfg, device="cpu")


@pytest.mark.parametrize("niter", [0, 10])
def test_cgnr_recon_records_its_solver_spans(niter):
    """A CGNR recon opens, inside each `tron.frame`, one `tron.cgnr` that
    holds its `tron.cgnr_rhs` and then ``niter`` `tron.cgnr_iter` spans, in
    that order and apart, between the frame's `tron.angles` and its
    `tron.combine`; the direct adjoint (niter 0), whose angles are rows of
    one table and whose combine runs in the frame's chain, opens none of
    them."""
    out, spans = _profiled(_cgnr_recon(niter))
    assert out.shape == (NZ, 1, NRO // 2, NRO // 2)
    by = {name: [(s, e) for s, e, n in spans if n == name] for name in tracing.SPANS}
    if niter == 0:
        assert not any(by[n] for n in CGNR + HALF)
        return
    assert [len(by[n]) for n in CGNR] == [NZ, NZ, NZ * niter]
    _frame_half(by)
    for z, ((fs, fe), (cs, ce)) in enumerate(zip(by["tron.frame"], by["tron.cgnr"])):
        assert fs <= cs and ce <= fe
        steps = [by["tron.cgnr_rhs"][z]] + by["tron.cgnr_iter"][z * niter:(z + 1) * niter]
        assert cs <= steps[0][0] and steps[-1][1] <= ce
        assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:])), steps


def test_cgnr_spans_off_change_no_bit():
    """With no profiler the solver's spans enter no record_function, and a
    CGNR recon's images are bitwise those of a profiled run."""
    run = _cgnr_recon(10)
    want, spans = _profiled(run)
    assert {n for _, _, n in spans} >= set(CGNR + HALF)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", lambda name: pytest.fail(name))
        np.testing.assert_array_equal(run(), want)


def test_cgnr_graph_span_is_listed():
    """The capture of the CGNR step is a span of its own, after the
    iteration's."""
    i = tracing.SPANS.index("tron.cgnr_iter")
    assert tracing.SPANS[i + 1] == "tron.cgnr_graph"


TOEPLITZ_CASES = {"toeplitz": {"niter": 10, "toeplitz": True}, "pair": {"niter": 10},
                  "adjoint": {}}


def _toeplitz_recon(case: str):
    indata, cfg = _input(1), _cfg(**TOEPLITZ_CASES[case])
    return lambda: recon.recon_radial2d(indata, cfg, device="cpu")


@pytest.mark.parametrize("case", list(TOEPLITZ_CASES))
def test_toeplitz_psf_span_one_a_frame_inside_the_solve(case):
    """A Toeplitz recon opens one `tron.toeplitz_psf` a frame, inside that
    frame's `tron.cgnr` and before its right side; a recon on the pair's
    normal operator, and the direct adjoint, open none.  Both CGNR recons
    open the frame's `tron.angles` before the solve and its `tron.combine`
    after it; the direct adjoint opens neither."""
    out, spans = _profiled(_toeplitz_recon(case))
    assert out.shape == (NZ, 1, NRO // 2, NRO // 2)
    by = {name: [(s, e) for s, e, n in spans if n == name] for name in tracing.SPANS}
    if case == "adjoint":
        assert not any(by[n] for n in HALF)
    else:
        _frame_half(by)
    if case != "toeplitz":
        assert not by["tron.toeplitz_psf"]
        return
    assert len(by["tron.toeplitz_psf"]) == len(by["tron.cgnr"]) == NZ
    for (ps, pe), (cs, ce), (rs, _) in zip(by["tron.toeplitz_psf"], by["tron.cgnr"],
                                           by["tron.cgnr_rhs"]):
        assert cs <= ps and pe <= rs and pe <= ce


def test_toeplitz_spans_off_change_no_bit():
    """With no profiler a Toeplitz recon enters no record_function, and its
    images are bitwise those of a profiled run."""
    run = _toeplitz_recon("toeplitz")
    want, spans = _profiled(run)
    assert {n for _, _, n in spans} >= {"tron.toeplitz_psf", *HALF}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", lambda name: pytest.fail(name))
        np.testing.assert_array_equal(run(), want)


def test_toeplitz_psf_span_is_listed():
    """The multiplier's build is a span of its own, after the capture's."""
    i = tracing.SPANS.index("tron.cgnr_graph")
    assert tracing.SPANS[i + 1] == "tron.toeplitz_psf"


FORWARD_CASES = {"2d": {}, "koosh": {"koosh": True}}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_opens_one_angles_span_a_call(case):
    """A forward recon (2-D, and `-3`'s slices) builds its one angle set in
    one `tron.angles`, before its frames, and no combine; with no profiler
    its samples are bitwise those of a profiled run."""
    x = np.random.default_rng(29).standard_normal((2, 2, 1, 32, 32, 3), np.float32)
    imgs = (x[0] + 1j * x[1]).astype(np.complex64)
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, skip_angles=7,
                      **FORWARD_CASES[case])

    def run():
        return recon.recon_radial2d(imgs, cfg, device="cpu")

    want, spans = _profiled(run)
    assert want.shape == (3, 2, 1, 32, 64)
    names = [n for _, _, n in spans]
    assert names.count("tron.angles") == 1 and "tron.combine" not in names
    angles = next(iv for iv in spans if iv[2] == "tron.angles")
    assert all(angles[1] <= s for s, _, n in spans if n == "tron.frame")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", lambda name: pytest.fail(name))
        np.testing.assert_array_equal(run(), want)
