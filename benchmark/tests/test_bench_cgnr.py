"""The CGNR cell's parts on the CPU at a tiny geometry (2 coils, 64
readouts, 3 frames of 25 spokes, 10 iterations), added beside the tiny
cells of `conftest.py` as `whole_body_cgnr.pair` adds itself: a
configuration, the mix `pair` naming `reference/cgnr.py`, the cell's limit
and its four metrics' entries.

On the CPU the solver's "auto" operators are the autograd transpose of the
plain forward, which wraps KB footprints at the grid's edge (the JAX
package's CPU route); the card takes the kernel pair, whose forward clips
them, and so does the reference.  The runs here put the pair in "auto"'s
place (``pair_route``): the route the card takes, through the kernels'
plain versions.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, roofline, run, spec, traffic
from benchmark import trace as tr
from benchmark.reference import cgnr as reference
from benchmark.reference.nufft import golden_angles
from benchmark.tests.conftest import TINY, make_tiny_root

CELL = "tiny.pair"
METRICS = ("cgnr_iter_ms", "cgnr_launches_per_iter", "cgnr_grid_roofline_pct",
           "cgnr_degrid_roofline_pct")
B1 = ("grid_tile_band_kernel", "grid_tile_items_kernel", "grid_tile_contract_kernel",
      "grid_tile_reduce_kernel")


def make_cgnr_root(dest: Path) -> Path:
    """`make_tiny_root` plus `tiny.pair`: the whole-body CGNR
    configuration at the tiny shapes under the mix `pair`, with the
    whole-body CGNR cell's limit and metrics."""
    root = make_tiny_root(dest)
    s = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = {**json.loads((root / "configs" / "whole_body_cgnr.json").read_text()), **TINY,
           "name": "tinycgnr"}
    (root / "configs" / "tinycgnr.json").write_text(json.dumps(cfg))
    s["configs"].append({"name": "tinycgnr", "source": "test",
                         "file": "benchmark/configs/tinycgnr.json", "reduced": [],
                         "why": "test"})
    mix = json.loads((root / "traffic" / "pair.json").read_text())
    (root / "traffic" / "tinypair.json").write_text(json.dumps({**mix, "traced_msamples": 0.015}))
    s["workloads"].append({"name": CELL, "config": "tinycgnr", "traffic": "tinypair",
                           "chips": 1, "why": "test"})
    shutil.copy(root / "limits" / "whole_body_cgnr.pair.json", root / "limits" / f"{CELL}.json")
    for m in s["per_layer"]:
        if "whole_body_cgnr.pair" in m["workloads"]:
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(s))
    return root


@pytest.fixture(scope="module")
def cgnr_root(tmp_path_factory) -> Path:
    return make_cgnr_root(tmp_path_factory.mktemp("cgnr"))


def _solver_with(monkeypatch, operators="pair", **changes):
    """The frame loop's solver with ``operators`` and ``cfg`` changes."""
    import tron_tpu_torch.recon as R
    from tron_tpu_torch import solver

    def cgnr(data, angles, cfg, **k):
        return solver.cgnr_radial2d(data, angles, dataclasses.replace(cfg, **changes),
                                    operators=operators, **k)
    monkeypatch.setattr(R, "cgnr_radial2d", cgnr)


@pytest.fixture
def pair_route(monkeypatch):
    _solver_with(monkeypatch)


def _run(root, seed=2**32 + 21, trace=False):
    return run.run_cell(spec.load_cell(CELL, root), seed, 0.3, trace, torch.device("cpu"))


def test_cell_and_mix_name_their_parts(cgnr_root):
    cell = spec.load_cell(CELL, cgnr_root)
    assert cell.reference == "cgnr" and cell.recon["niter"] == 10
    assert cell.recon["toeplitz"] is False
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert traffic.geometry(cell)["niter"] == 10
    real = spec.load_cell("whole_body_cgnr.pair")
    g = traffic.geometry(real)
    assert (g["nz"], g["work"], g["slide"], g["nc"], g["nro"]) == (120, 204, 21, 6, 512)
    assert traffic.series_samples(g) == 75_202_560
    assert traffic.traced_series(real, g) == 1


def test_sound_run_is_correct(cgnr_root, pair_route):
    r = _run(cgnr_root)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["frame_rel_err"]["value"] < 5e-5


def test_reference_matches_the_ports_cpu_pair(cgnr_root, pair_route):
    """Every frame of a series through `recon_radial2d` with the pair
    (float32, the plain versions) within 5e-5 of the reference: one
    operator in float32, KB weights and positions in float32 against
    float64, sums in other orders over 21 operator applications a frame;
    they read ~2e-6.  The reference's bfloat16 operands read far outside."""
    from benchmark.program import Program

    cell = spec.load_cell(CELL, cgnr_root)
    geo = traffic.geometry(cell)
    indata = traffic.make_input(geo, 2**31 + 77, torch.device("cpu"))
    served = Program(cell.recon, cell.config["precision"], torch.device("cpu")).series(indata)
    ref = reference.Series(indata, cell.recon, "cpu")
    want = ref.frames(list(range(geo["nz"])))
    assert served.shape == tuple(want.shape) == (3, 32, 32)
    assert check.frame_errors(served, want).max() < 5e-5
    assert check.frame_errors(ref.frames([0, 1, 2], "bfloat16"), want).min() > 1e-3


def _one_iteration_fewer(monkeypatch):
    """Each frame solved by niter - 1 iterations."""
    _solver_with(monkeypatch, niter=9)


def _wrapped_forward(monkeypatch):
    """The pair's forward wraps KB footprints at the grid's edge."""
    from tron_tpu_torch import solver

    orig = solver.nufft_forward
    _solver_with(monkeypatch)
    monkeypatch.setattr(solver, "nufft_forward",
                        lambda *a, **k: orig(*a, **{**k, "wrap": True}))


def _readout0_weighted(monkeypatch):
    """Readout 0 left weighted.  On the pair this changes no bit (B1 never
    grids readout 0), so it is planted where readout 0 enters A^H: the
    autograd transpose of the clipped forward, which with readout 0
    weighted out is the pair (`test_readout0_matters_only_where_gridded`)."""
    from tron_tpu_torch import nufft, solver

    orig = solver.nufft_forward
    _solver_with(monkeypatch, operators="transpose")
    monkeypatch.setattr(solver, "nufft_forward",
                        lambda *a, **k: orig(*a, **{**k, "wrap": False}))
    monkeypatch.setattr(solver, "_weights", lambda cfg, nro, npe, device, sample_mask=None:
                        nufft.sdc_weights(cfg, nro, npe, device).clone())


FAULTS = [_one_iteration_fewer, _wrapped_forward, _readout0_weighted]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_reads_incorrect(cgnr_root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(cgnr_root)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["frame_rel_err"]["value"] > r["checks"]["frame_rel_err"]["limit"]


def test_readout0_matters_only_where_gridded(cgnr_root, monkeypatch):
    """The transpose of the clipped forward with readout 0 weighted out
    reads as the pair; the pair with readout 0 left weighted is bitwise
    the pair."""
    from benchmark.program import Program
    from tron_tpu_torch import nufft, solver

    cell = spec.load_cell(CELL, cgnr_root)
    indata = traffic.make_input(traffic.geometry(cell), 5, torch.device("cpu"))

    def series():
        return Program(cell.recon, cell.config["precision"], torch.device("cpu")).series(indata)

    with monkeypatch.context() as m:
        _solver_with(m)
        pair = series()
        m.setattr(solver, "_weights", lambda cfg, nro, npe, device, sample_mask=None:
                  nufft.sdc_weights(cfg, nro, npe, device).clone())
        np.testing.assert_array_equal(series(), pair)
    with monkeypatch.context() as m:
        orig = solver.nufft_forward
        _solver_with(m, operators="transpose")
        m.setattr(solver, "nufft_forward", lambda *a, **k: orig(*a, **{**k, "wrap": False}))
        assert check.frame_errors(series(), torch.from_numpy(pair)).max() < 5e-5


@pytest.mark.parametrize("quant,correct", [("float32", True), ("float8_e4m3", False)])
def test_control_reads_incorrect(cgnr_root, monkeypatch, quant, correct):
    """The reference at float8 e4m3 in the program's place fails the
    cell's limit; at float32 it passes."""
    from benchmark.program import Program

    cell = spec.load_cell(CELL, cgnr_root)

    def series(self, indata):
        ref = reference.Series(indata, cell.recon, "cpu")
        return ref.frames(list(range(ref.nz)), quant).numpy()

    monkeypatch.setattr(Program, "series", series)
    assert _run(cgnr_root)["correct"] is correct


def test_reference_refuses_settings_it_does_not_work_out():
    indata = np.zeros((1, 1, 8, 8), np.complex64)
    recon = {"adjoint": True, "golden_angle": True, "data_undersamp": 1.0, "prof_slide": 0,
             "gridos": 2.0, "kernwidth": 2.0, "skip_angles": 0, "niter": 3, "toeplitz": False}
    reference.Series(indata, recon, "cpu")
    for bad in ({"toeplitz": True}, {"niter": 0}, {"gridos": 1.5}, {"adjoint": False},
                {"sdc": "ideal"}):
        with pytest.raises(ValueError):
            reference.Series(indata, {**recon, **bad}, "cpu")


def _trace(host, device=(), series=((0.0, 10_000.0), (20_000.0, 30_000.0)), geo=None):
    launches = sum(n in tr.LAUNCH_CALLS for _, _, n in host)
    return tr.Trace(list(series), list(device), list(host), launches, geo or {"nz": 2})


# two series, each of two iterations: 3 + 2 and 1 + 2 launches inside the
# spans, and one launch that no span holds
HOST = [
    (100.0, 300.0, "tron.cgnr_iter"), (110.0, 111.0, "cudaLaunchKernel"),
    (120.0, 121.0, "cudaLaunchKernel"), (130.0, 131.0, "cuLaunchKernel"),
    (300.0, 400.0, "tron.cgnr_iter"), (310.0, 311.0, "cudaLaunchKernel"),
    (350.0, 351.0, "cudaLaunchKernel"), (450.0, 451.0, "cudaLaunchKernel"),
    (20_100.0, 20_700.0, "tron.cgnr_iter"), (20_200.0, 20_201.0, "cudaLaunchKernel"),
    (20_700.0, 21_000.0, "tron.cgnr_iter"), (20_800.0, 20_801.0, "cudaLaunchKernel"),
    (20_900.0, 20_901.0, "cudaLaunchKernel"),
]


def test_span_readers_on_a_synthetic_trace():
    """cgnr_iter_ms: the mean iteration span; cgnr_launches_per_iter: the
    launches inside the spans over their count; both None without the
    spans."""
    t = _trace(HOST)
    assert spec.metric_reader("cgnr_iter_ms")(t) == pytest.approx((200 + 100 + 600 + 300) / 4e3)
    assert spec.metric_reader("cgnr_launches_per_iter")(t) == pytest.approx(8 / 4)
    bare = _trace([h for h in HOST if h[2] != "tron.cgnr_iter"])
    for name in ("cgnr_iter_ms", "cgnr_launches_per_iter"):
        assert spec.metric_reader(name)(bare) is None
        assert spec.metric_reader(name)(_trace([])) is None


def test_tiny_traced_series_read_the_solver_spans(cgnr_root, pair_route):
    """The tiny cell's series profiled as a traced run profiles them: on
    the CPU the iteration spans read a time, 10 a frame, and nothing
    launches (no device), so the launch count and the kernels' shares read
    None."""
    from benchmark.program import Program

    cell = spec.load_cell(CELL, cgnr_root)
    geo = traffic.geometry(cell)
    program = Program(cell.recon, cell.config["precision"], torch.device("cpu"))
    indata = traffic.make_input(geo, 2**31 + 17, torch.device("cpu"))
    n = traffic.traced_series(cell, geo)
    t = tr.reduce(tr.profile(lambda _: program.series(indata), n), geo)
    assert len(t.series) == n == 2
    assert sum(n == "tron.cgnr_iter" for _, _, n in t.host) == 2 * 3 * 10
    assert spec.metric_reader("cgnr_iter_ms", cgnr_root)(t) > 0
    for name in METRICS[1:]:
        assert spec.metric_reader(name, cgnr_root)(t) is None


@pytest.mark.parametrize("extra", [0, 1])
def test_roofline_readers_count_the_solvers_passes(cgnr_root, extra):
    """Each frame's frozen bound, niter + 1 times for B1 (the right side and
    one adjoint an iteration), niter times for B3 (one forward an
    iteration), over the kernels' device time: a solver that grids or
    degrids each frame ``extra`` times more reads that much less; a
    profile without the kernel, or a geometry with no iteration, reads
    None."""
    g = traffic.geometry(spec.load_cell(CELL, cgnr_root))
    niter = g["niter"]
    angles = [golden_angles(g["work"], g["skip"] + z * g["slide"]) for z in range(g["nz"])]
    grid_us = 1e3 * sum(roofline.grid_bound(g["work"], 2 * g["nc"], a, g["nxos"],
                                            g["kernwidth"])[0] for a in angles)
    degrid_us = 1e3 * sum(roofline.degrid_bound(g["work"], g["nc"], a, g["nxos"], g["nro"],
                                                g["kernwidth"])[0] for a in angles)
    series = [(0.0, 1e5), (1e5, 2e5)]
    grids, degrids = g["nz"] * (niter + 1 + extra), g["nz"] * (niter + extra)
    device = [(s + i, s + i + 0.5, f"void (anonymous namespace)::{k}<12, 0, float>(...)")
              for s, _ in series for i in range(grids) for k in B1]
    device += [(s + i, s + i + 3.0, "void (anonymous namespace)::degrid_radial2d_kernel<4, 4, 8,"
                " 0>(...)") for s, _ in series for i in range(degrids)]
    device.append((5.0, 50.0, "Memcpy HtoD (Pageable -> Device)"))
    t = tr.Trace(series, device, [], 0, g)
    got_grid = spec.metric_reader("cgnr_grid_roofline_pct", cgnr_root)(t)
    got_degrid = spec.metric_reader("cgnr_degrid_roofline_pct", cgnr_root)(t)
    assert got_grid == pytest.approx(
        100.0 * (niter + 1) * 2 * grid_us / (2 * grids * 4 * 0.5), rel=1e-12)
    assert got_degrid == pytest.approx(
        100.0 * niter * 2 * degrid_us / (2 * degrids * 3.0), rel=1e-12)
    for name in METRICS[2:]:
        read = spec.metric_reader(name, cgnr_root)
        assert read(tr.Trace(series, device[-1:], [], 0, g)) is None
        assert read(tr.Trace(series, device, [], 0, {**g, "niter": 0})) is None


@pytest.mark.gpu
def test_card_cgnr_run_and_trace(cgnr_root, card):
    """On the card: the tiny CGNR cell through the kernel pair reads
    ``correct`` true under its limit, plain and traced, and a traced run
    reads all four metrics, the kernels' shares in (0, 100]."""
    cell = spec.load_cell(CELL, cgnr_root)
    r = run.run_cell(cell, 2**31 + 41, 1.0, False, card)
    assert r["correct"] is True, r["checks"]
    r = run.run_cell(cell, 2**31 + 42, 1.0, True, card)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == set(METRICS)
    for name in METRICS[2:]:
        assert 0 < r["metrics"][name]["value"] <= 100, (name, r["metrics"][name])
    assert r["metrics"]["cgnr_launches_per_iter"]["value"] > 0
    assert r["metrics"]["cgnr_iter_ms"]["value"] > 0
