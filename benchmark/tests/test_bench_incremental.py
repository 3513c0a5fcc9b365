"""The telescoping scheduler's cell's parts on the CPU at a tiny geometry (2
coils, 64 readouts, 3 frames of 25 spokes sliding by 21), added beside the
tiny cells of `conftest.py` as `whole_body_incremental.incremental` adds
itself: a configuration, the mix `incremental` naming
`reference/incremental.py`, the cell's limit and its three metrics'
entries."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, roofline, run, spec, traffic
from benchmark import trace as tr
from benchmark.reference import incremental as reference
from benchmark.reference import recon as recon_reference
from benchmark.reference.nufft import golden_angles
from benchmark.tests.conftest import TINY, make_tiny_root

CELL = "tiny.incremental"
REAL = "whole_body_incremental.incremental"
METRICS = ("incremental_step_ms", "incremental_launches_per_step",
           "incremental_grid_roofline_pct")
B1 = ("grid_tile_band_kernel", "grid_tile_items_kernel", "grid_tile_contract_kernel",
      "grid_tile_reduce_kernel")
RECON = {"adjoint": True, "golden_angle": True, "data_undersamp": 1.0, "prof_slide": 0,
         "gridos": 2.0, "kernwidth": 2.0, "skip_angles": 0, "niter": 0}


def make_incremental_root(dest: Path) -> Path:
    """`make_tiny_root` plus `tiny.incremental`: the whole-body incremental
    configuration at the tiny shapes under the mix `incremental`, with the
    whole-body incremental cell's limit and metrics."""
    root = make_tiny_root(dest)
    s = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = {**json.loads((root / "configs" / "whole_body_incremental.json").read_text()), **TINY,
           "name": "tinyincremental"}
    (root / "configs" / "tinyincremental.json").write_text(json.dumps(cfg))
    s["configs"].append({"name": "tinyincremental", "source": "test",
                         "file": "benchmark/configs/tinyincremental.json", "reduced": [],
                         "why": "test"})
    mix = json.loads((root / "traffic" / "incremental.json").read_text())
    (root / "traffic" / "tinyincremental.json").write_text(
        json.dumps({**mix, "traced_msamples": 0.015}))
    s["workloads"].append({"name": CELL, "config": "tinyincremental",
                           "traffic": "tinyincremental", "chips": 1, "why": "test"})
    shutil.copy(root / "limits" / f"{REAL}.json", root / "limits" / f"{CELL}.json")
    for m in s["per_layer"]:
        if REAL in m["workloads"]:
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(s))
    return root


@pytest.fixture(scope="module")
def incremental_root(tmp_path_factory) -> Path:
    return make_incremental_root(tmp_path_factory.mktemp("incremental"))


def _run(root, seed=2**32 + 27, trace=False):
    return run.run_cell(spec.load_cell(CELL, root), seed, 0.3, trace, torch.device("cpu"))


def test_cell_config_mix_limit_and_metrics_load(incremental_root):
    cell = spec.load_cell(CELL, incremental_root)
    assert cell.reference == "incremental" and cell.recon["incremental"] is True
    assert cell.recon["niter"] == 0
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    real = spec.load_cell(REAL)
    assert real.chips == 1 and real.config["reduced"] == []
    assert real.config["flags"] == "-a -G -u 0.4 -d 21 --incremental"
    whole_body = json.loads((Path(spec.HERE) / "configs" / "whole_body.json").read_text())
    assert real.config["recon"] == {**whole_body["recon"], "incremental": True}
    assert all(real.config[k] == whole_body[k] for k in
               ("nc", "nro", "npe1", "work", "slide", "nz", "precision"))
    g = traffic.geometry(real)
    assert (g["nz"], g["work"], g["slide"], g["nc"], g["nro"], g["niter"]) == (
        956, 204, 21, 6, 512, 0)
    assert traffic.series_samples(g) == 599_113_728
    assert traffic.traced_series(real, g) == 1
    assert {m["name"] for m in real.per_layer} == set(METRICS)
    assert 0 < real.limits["frame_rel_err"]["limit"] < 1e-2
    for m in real.per_layer:
        assert m["workloads"] == [REAL] and m["moves"] == "msamples_per_s"


def test_sound_run_is_correct(incremental_root):
    r = _run(incremental_root)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["frame_rel_err"]["value"] < 1e-5


def test_reference_grids_each_frame_whole():
    """The reference's frames are `recon.py`'s direct frames, bit for bit,
    whatever frames are asked for together."""
    x = np.random.default_rng(3).standard_normal((2, 2, 1, 64, 74), np.float32)
    indata = (x[0] + 1j * x[1]).astype(np.complex64)
    recon = {**RECON, "data_undersamp": 0.4, "prof_slide": 21}
    inc = reference.Series(indata, {**recon, "incremental": True}, "cpu")
    direct = recon_reference.Series(indata, recon, "cpu")
    assert (inc.work, inc.slide, inc.nz) == (25, 21, 3)
    assert torch.equal(inc.frames([0, 1, 2]), direct.frames([0, 1, 2]))
    assert torch.equal(inc.frames([2]), direct.frames([0, 1, 2])[2:])


def test_reference_refuses_settings_it_does_not_work_out():
    indata = np.zeros((1, 1, 8, 8), np.complex64)
    reference.Series(indata, {**RECON, "incremental": True}, "cpu")
    reference.Series(indata, RECON, "cpu")
    for bad in ({"incremental": False}, {"niter": 1}, {"adjoint": False},
                {"golden_angle": False}, {"toeplitz": True}, {"sdc": "ideal"}):
        for base in (RECON, {**RECON, "incremental": True}):
            with pytest.raises(ValueError):
                reference.Series(indata, {**base, **bad}, "cpu")
            if "incremental" not in bad:
                with pytest.raises(ValueError):
                    recon_reference.Series(indata, {**RECON, **bad}, "cpu")


def _unsigned(monkeypatch):
    """The leaving spokes added, not taken away."""
    from tron_tpu_torch import recon

    scan = recon.incremental_scan

    def unsigned(window, angles_of, gridw, frame_image, work, slide, *a, **k):
        def gridw_abs(win, ang):
            if win.shape[0] == 2 * slide:
                win = torch.cat([-win[:slide], win[slide:]])
            return gridw(win, ang)
        return scan(window, angles_of, gridw_abs, frame_image, work, slide, *a, **k)

    monkeypatch.setattr(recon, "incremental_scan", unsigned)


def _unscaled(monkeypatch):
    """The delta left at its own 1/(nxos 2 slide), not the frame's."""
    from tron_tpu_torch import recon

    scan = recon.incremental_scan

    def unscaled(window, angles_of, gridw, frame_image, work, slide, *a, **k):
        def gridw_own(win, ang):
            g = gridw(win, ang)
            return g if win.shape[0] == work else g * (work / (2.0 * slide))
        return scan(window, angles_of, gridw_own, frame_image, work, slide, *a, **k)

    monkeypatch.setattr(recon, "incremental_scan", unscaled)


def _stale_angles(monkeypatch):
    """The entering spokes gridded at the leaving ones' angles."""
    from tron_tpu_torch import recon

    scan = recon.incremental_scan

    def stale(window, angles_of, gridw, frame_image, work, slide, *a, **k):
        def gridw_stale(win, ang):
            if win.shape[0] == 2 * slide:
                ang = torch.cat([ang[:slide], ang[:slide]])
            return gridw(win, ang)
        return scan(window, angles_of, gridw_stale, frame_image, work, slide, *a, **k)

    monkeypatch.setattr(recon, "incremental_scan", stale)


FAULTS = [_unsigned, _unscaled, _stale_angles]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_reads_incorrect(incremental_root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(incremental_root)
    assert r["correct"] is False and r["failed"] >= 1
    value = r["checks"]["frame_rel_err"]["value"]
    assert float(value) > r["checks"]["frame_rel_err"]["limit"]


@pytest.mark.parametrize("quant,correct", [("float32", True), ("float8_e4m3", False)])
def test_control_reads_incorrect(incremental_root, monkeypatch, quant, correct):
    """The reference at float8 e4m3 in the program's place fails the
    cell's limit; at float32 it passes."""
    from benchmark.program import Program

    cell = spec.load_cell(CELL, incremental_root)

    def series(self, indata):
        ref = reference.Series(indata, cell.recon, "cpu")
        return ref.frames(list(range(ref.nz)), quant).numpy()

    monkeypatch.setattr(Program, "series", series)
    assert _run(incremental_root)["correct"] is correct


SERIES = [(0.0, 10_000.0), (20_000.0, 30_000.0)]
HOST = [(100.0, 400.0, "tron.incremental_step"), (110.0, 111.0, "cudaLaunchKernel"),
        (120.0, 121.0, "cudaLaunchKernel"), (500.0, 501.0, "cudaLaunchKernel"),
        (900.0, 1000.0, "tron.incremental_step"), (950.0, 951.0, "cuLaunchKernel"),
        (20_100.0, 20_700.0, "tron.incremental_step"), (20_200.0, 20_201.0, "cudaGraphLaunch"),
        (20_300.0, 20_301.0, "cudaLaunchKernel"), (20_400.0, 20_401.0, "cudaLaunchKernel")]


def test_step_reader_on_a_synthetic_trace():
    """incremental_step_ms: the mean step span over the profiled series;
    None without the span."""
    read = spec.metric_reader("incremental_step_ms")
    assert read(tr.Trace(SERIES, [], HOST, 6, {"nz": 2})) == pytest.approx(
        (300 + 100 + 600) / 3e3)
    assert read(tr.Trace(SERIES, [], [h for h in HOST if h[2] != "tron.incremental_step"], 6,
                         {"nz": 2})) is None
    assert read(tr.Trace(SERIES, [], [], 0, {"nz": 2})) is None


def test_launches_reader_on_a_synthetic_trace():
    """incremental_launches_per_step: launch calls starting inside the
    step spans over their count (the one at 500 us is outside); None
    without the span or without a launch."""
    read = spec.metric_reader("incremental_launches_per_step")
    assert read(tr.Trace(SERIES, [], HOST, 6, {"nz": 2})) == pytest.approx(6 / 3)
    assert read(tr.Trace(SERIES, [], [h for h in HOST if h[2] != "tron.incremental_step"], 6,
                         {"nz": 2})) is None
    assert read(tr.Trace(SERIES, [], [h for h in HOST if h[2] == "tron.incremental_step"], 0,
                         {"nz": 2})) is None


def _b1_trace(g, us=0.5):
    device = [(s + f, s + f + us, f"void (anonymous namespace)::{k}<2, 0, float>(...)")
              for s, _ in SERIES for f in range(g["nz"]) for k in B1]
    device.append((5.0, 50.0, "Memcpy HtoD (Pageable -> Device)"))
    return device


def test_roofline_reader_counts_frame_0_and_every_delta(incremental_root):
    """The frozen bound of a series is `grid_bound` of frame 0's window
    plus that of each later frame's 2 slide spokes (the leaving ones at
    their angles, then the entering ones), summed over the profiled series
    and over B1's device time; None without B1."""
    g = traffic.geometry(spec.load_cell(CELL, incremental_root))
    work, slide, K = g["work"], g["slide"], 2 * g["nc"]
    want_ms = roofline.grid_bound(work, K, golden_angles(work, 0), g["nxos"], 2.0)[0]
    for z in range(1, g["nz"]):
        leaving = golden_angles(slide, (z - 1) * slide)
        entering = golden_angles(slide, (z - 1) * slide + work)
        want_ms += roofline.grid_bound(2 * slide, K, torch.cat([leaving, entering]), g["nxos"],
                                       2.0)[0]
    device = _b1_trace(g)
    read = spec.metric_reader("incremental_grid_roofline_pct", incremental_root)
    got = read(tr.Trace(SERIES, device, [], 0, g))
    assert got == pytest.approx(100.0 * 2 * want_ms * 1e3 / (2 * g["nz"] * 4 * 0.5), rel=1e-12)
    assert read(tr.Trace(SERIES, device[-1:], [], 0, g)) is None
    assert read(tr.Trace([], [], [], 0, g)) is None


def test_roofline_bound_at_whole_body_size():
    """At the whole-body geometry a delta's bound is set by its bytes, most
    of them the 6 grids it writes (12.6 MB of its 13.6), so the series'
    bound, frame 0's window and 955 deltas, is about three quarters of the
    direct series' 956 windows, not the fifth its spokes are."""
    mod = spec._load_module(spec.HERE / "metrics" / "incremental_grid_roofline_pct.py", "m")
    g = traffic.geometry(spec.load_cell(REAL))
    a = torch.cat([golden_angles(21, 500 * 21), golden_angles(21, 500 * 21 + 204)])
    ms, by = roofline.grid_bound(42, 12, a, 512, 2.0)
    assert by == "bytes" and ms == pytest.approx(1e3 * (42 * 512 * 48 + 42 * 4 + 6 * 512 * 512 * 8)
                                                 / roofline.HBM_BYTES_PER_S)
    direct = g["nz"] * roofline.grid_bound(204, 12, golden_angles(204, 0), 512, 2.0)[0]
    assert 0.7 * direct < mod.series_ms(g) < 0.85 * direct


def test_tiny_traced_series_read_the_step_span(incremental_root):
    """The tiny cell's series profiled as a traced run profiles them: on
    the CPU the step spans read a time, nz - 1 a series, and no launch call
    and no B1 kernel is recorded (no device), so those two read None."""
    from benchmark.program import Program

    cell = spec.load_cell(CELL, incremental_root)
    geo = traffic.geometry(cell)
    program = Program(cell.recon, cell.config["precision"], torch.device("cpu"))
    indata = traffic.make_input(geo, 2**31 + 19, torch.device("cpu"))
    n = traffic.traced_series(cell, geo)
    t = tr.reduce(tr.profile(lambda _: program.series(indata), n), geo)
    assert len(t.series) == n == 2
    assert sum(n == "tron.incremental_step" for _, _, n in t.host) == 2 * (geo["nz"] - 1)
    assert spec.metric_reader("incremental_step_ms", incremental_root)(t) > 0
    assert spec.metric_reader("incremental_launches_per_step", incremental_root)(t) is None
    assert spec.metric_reader("incremental_grid_roofline_pct", incremental_root)(t) is None


def test_kept_series_is_judged_whole(incremental_root):
    """The comparison judges every frame of the kept series: the last
    frame alone off by 1 % fails the run."""
    cell = spec.load_cell(CELL, incremental_root)
    geo = traffic.geometry(cell)
    indata = traffic.make_input(geo, 11, torch.device("cpu"))
    ref = reference.Series(indata, cell.recon, "cpu")
    frames = ref.frames(list(range(geo["nz"]))).numpy()
    off = frames.copy()
    off[-1] *= 1.01
    limit = cell.limits["frame_rel_err"]["limit"]
    for served, ok in ((frames, True), (off, False)):
        res = check.compare(indata, reference, cell.recon,
                            {0: (np.arange(geo["nz"]), served)}, "cpu")
        assert (res["worst"][0] <= limit) is ok


@pytest.mark.gpu
def test_card_incremental_run_and_trace(incremental_root, card):
    """On the card: the tiny incremental cell reads ``correct`` true under
    its limit, plain and traced, and a traced run reads the three metrics,
    the share in (0, 100]."""
    cell = spec.load_cell(CELL, incremental_root)
    r = run.run_cell(cell, 2**31 + 45, 1.0, False, card)
    assert r["correct"] is True, r["checks"]
    r = run.run_cell(cell, 2**31 + 46, 1.0, True, card)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == set(METRICS)
    assert 0 < r["metrics"]["incremental_grid_roofline_pct"]["value"] <= 100
    assert r["metrics"]["incremental_step_ms"]["value"] > 0
    assert r["metrics"]["incremental_launches_per_step"]["value"] > 0
