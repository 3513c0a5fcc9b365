"""The Toeplitz CGNR cell's parts on the CPU at a tiny geometry (2 coils, 64
readouts, 3 frames of 25 spokes, 10 iterations), added beside the tiny
cells of `conftest.py` as `whole_body_toeplitz.toeplitz` adds itself: a
configuration, the mix `toeplitz` naming `reference/cgnr_toeplitz.py`, the
cell's limit and its two metrics' entries.

On the CPU the solver's "auto" right side is the autograd transpose of the
plain forward, which wraps KB footprints at the grid's edge (the JAX
package's CPU route); the card takes the kernel pair's gridding adjoint,
and so does the reference.  The runs here put the pair in "auto"'s place
(``card_route``): the route the card takes, through the kernels' plain
versions.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, roofline, run, spec, traffic
from benchmark import trace as tr
from benchmark.reference import cgnr_toeplitz as reference
from benchmark.reference.nufft import golden_angles
from benchmark.tests.conftest import TINY, make_tiny_root

CELL = "tiny.toeplitz"
METRICS = ("toeplitz_psf_ms", "toeplitz_grid_roofline_pct")
B1 = ("grid_tile_band_kernel", "grid_tile_items_kernel", "grid_tile_contract_kernel",
      "grid_tile_reduce_kernel")


def make_toeplitz_root(dest: Path) -> Path:
    """`make_tiny_root` plus `tiny.toeplitz`: the whole-body Toeplitz
    configuration at the tiny shapes under the mix `toeplitz`, with the
    whole-body Toeplitz cell's limit and metrics."""
    root = make_tiny_root(dest)
    s = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = {**json.loads((root / "configs" / "whole_body_toeplitz.json").read_text()), **TINY,
           "name": "tinytoeplitz"}
    (root / "configs" / "tinytoeplitz.json").write_text(json.dumps(cfg))
    s["configs"].append({"name": "tinytoeplitz", "source": "test",
                         "file": "benchmark/configs/tinytoeplitz.json", "reduced": [],
                         "why": "test"})
    mix = json.loads((root / "traffic" / "toeplitz.json").read_text())
    (root / "traffic" / "tinytoeplitz.json").write_text(
        json.dumps({**mix, "traced_msamples": 0.015}))
    s["workloads"].append({"name": CELL, "config": "tinytoeplitz", "traffic": "tinytoeplitz",
                           "chips": 1, "why": "test"})
    shutil.copy(root / "limits" / "whole_body_toeplitz.toeplitz.json",
                root / "limits" / f"{CELL}.json")
    for m in s["per_layer"]:
        if "whole_body_toeplitz.toeplitz" in m["workloads"]:
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(s))
    return root


@pytest.fixture(scope="module")
def toeplitz_root(tmp_path_factory) -> Path:
    return make_toeplitz_root(tmp_path_factory.mktemp("toeplitz"))


@pytest.fixture
def card_route(monkeypatch):
    """The Toeplitz solve with the pair's right side, as a CUDA tensor
    resolves "auto" (`solver._resolve`)."""
    from tron_tpu_torch import solver

    resolve = solver._resolve

    def on_the_card(operators, cfg, device):
        mode, toeplitz = resolve(operators, cfg, device)
        return ("pair" if toeplitz else mode), toeplitz

    monkeypatch.setattr(solver, "_resolve", on_the_card)


def _run(root, seed=2**32 + 25, trace=False):
    return run.run_cell(spec.load_cell(CELL, root), seed, 0.3, trace, torch.device("cpu"))


def test_cell_and_mix_name_their_parts(toeplitz_root):
    cell = spec.load_cell(CELL, toeplitz_root)
    assert cell.reference == "cgnr_toeplitz" and cell.recon["niter"] == 10
    assert cell.recon["toeplitz"] is True
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    real = spec.load_cell("whole_body_toeplitz.toeplitz")
    g = traffic.geometry(real)
    assert (g["nz"], g["work"], g["slide"], g["nc"], g["nro"], g["niter"]) == (
        918, 204, 21, 6, 512, 10)
    assert traffic.series_samples(g) == 575_299_584
    assert traffic.traced_series(real, g) == 1
    assert {m["name"] for m in real.per_layer} == set(METRICS)


def test_sound_run_is_correct(toeplitz_root, card_route):
    r = _run(toeplitz_root)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["frame_rel_err"]["value"] < 5e-5


def test_reference_matches_the_ports_card_route(toeplitz_root, card_route):
    """Every frame of a series through `recon_radial2d` on the card's route
    (float32, the plain versions) within 5e-5 of the reference: one
    operator in float32, KB weights and positions in float32 against
    float64, sums in other orders over the right side, the multiplier and
    10 FFT convolutions a frame; they read ~5e-6.  The reference's bfloat16
    operands read far outside."""
    from benchmark.program import Program

    cell = spec.load_cell(CELL, toeplitz_root)
    geo = traffic.geometry(cell)
    indata = traffic.make_input(geo, 2**31 + 77, torch.device("cpu"))
    served = Program(cell.recon, cell.config["precision"], torch.device("cpu")).series(indata)
    ref = reference.Series(indata, cell.recon, "cpu")
    want = ref.frames(list(range(geo["nz"])))
    assert served.shape == tuple(want.shape) == (3, 32, 32)
    assert check.frame_errors(served, want).max() < 5e-5
    assert check.frame_errors(ref.frames([0, 1, 2], "bfloat16"), want).min() > 1e-3


def _undoubled(monkeypatch):
    """The multiplier of the weights on the undoubled grid, applied as a
    circular convolution of the n x n image (offsets wrap; CG diverges)."""
    from tron_tpu_torch import solver
    from tron_tpu_torch.nufft import nufft_adjoint

    def kernel(angles, cfg, nro, **_):
        npe = int(angles.shape[0])
        w = solver._weights(cfg, nro, npe, angles.device).expand(npe, nro)
        t = nufft_adjoint(w.to(torch.complex64), angles, cfg, apply_sdc=False) * (nro * npe)
        return torch.fft.fft2(torch.fft.ifftshift(t, dim=(-2, -1)))

    monkeypatch.setattr(solver, "toeplitz_fourier_kernel", kernel)
    monkeypatch.setattr(solver, "toeplitz_apply",
                        lambda x, mult: torch.fft.ifft2(torch.fft.fft2(x) * mult).to(x.dtype))


def _scale_left_in(monkeypatch):
    """The gridder's 1/(nxos' npe) at the doubled geometry not undone."""
    from tron_tpu_torch import solver

    kernel = solver.toeplitz_fourier_kernel
    monkeypatch.setattr(solver, "toeplitz_fourier_kernel", lambda angles, cfg, nro, **k:
                        kernel(angles, cfg, nro, **k) / (int(nro * cfg.gridos) * angles.shape[0]))


def _readout0_weighted(monkeypatch):
    """Readout 0 weighted into the multiplier: each spoke's sample at radius
    -nro/2 with its Ram-Lak weight, added as the exact sum (the gridder
    never grids that radius)."""
    from tron_tpu_torch import solver
    from tron_tpu_torch.nufft import sdc_weights
    from tron_tpu_torch.oracle.dtft import dtft2_adjoint

    kernel = solver.toeplitz_fourier_kernel

    def with_readout0(angles, cfg, nro, **k):
        npe, r = int(angles.shape[0]), -nro / 2
        w0 = complex(sdc_weights(cfg, nro, npe, angles.device)[0])
        t0 = dtft2_adjoint(torch.full((npe,), w0), r * torch.cos(angles), r * torch.sin(angles),
                           nro, nro)
        return kernel(angles, cfg, nro, **k) + torch.fft.fft2(torch.fft.ifftshift(t0))

    monkeypatch.setattr(solver, "toeplitz_fourier_kernel", with_readout0)


FAULTS = [_undoubled, _scale_left_in, _readout0_weighted]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_reads_incorrect(toeplitz_root, card_route, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(toeplitz_root)
    assert r["correct"] is False and r["failed"] >= 1
    value = r["checks"]["frame_rel_err"]["value"]
    assert float(value) > r["checks"]["frame_rel_err"]["limit"]


@pytest.mark.parametrize("quant,correct", [("float32", True), ("float8_e4m3", False)])
def test_control_reads_incorrect(toeplitz_root, monkeypatch, quant, correct):
    """The reference at float8 e4m3 in the program's place fails the
    cell's limit; at float32 it passes."""
    from benchmark.program import Program

    cell = spec.load_cell(CELL, toeplitz_root)

    def series(self, indata):
        ref = reference.Series(indata, cell.recon, "cpu")
        return ref.frames(list(range(ref.nz)), quant).numpy()

    monkeypatch.setattr(Program, "series", series)
    assert _run(toeplitz_root)["correct"] is correct


def test_reference_refuses_settings_it_does_not_work_out():
    indata = np.zeros((1, 1, 8, 8), np.complex64)
    recon = {"adjoint": True, "golden_angle": True, "data_undersamp": 1.0, "prof_slide": 0,
             "gridos": 2.0, "kernwidth": 2.0, "skip_angles": 0, "niter": 3, "toeplitz": True}
    reference.Series(indata, recon, "cpu")
    for bad in ({"toeplitz": False}, {"niter": 0}, {"gridos": 1.5}, {"adjoint": False},
                {"sdc": "ideal"}):
        with pytest.raises(ValueError):
            reference.Series(indata, {**recon, **bad}, "cpu")


def test_psf_reader_on_a_synthetic_trace():
    """toeplitz_psf_ms: the mean build span over the profiled series; None
    without the span."""
    series = [(0.0, 10_000.0), (20_000.0, 30_000.0)]
    host = [(100.0, 400.0, "tron.toeplitz_psf"), (500.0, 700.0, "tron.cgnr_rhs"),
            (900.0, 1000.0, "tron.toeplitz_psf"), (20_100.0, 20_700.0, "tron.toeplitz_psf")]
    read = spec.metric_reader("toeplitz_psf_ms")
    assert read(tr.Trace(series, [], host, 0, {"nz": 2})) == pytest.approx(
        (300 + 100 + 600) / 3e3)
    assert read(tr.Trace(series, [], host[1:2], 0, {"nz": 2})) is None
    assert read(tr.Trace(series, [], [], 0, {"nz": 2})) is None


def _roofline_case(root, split: bool):
    """Two series' B1 passes of the tiny cell: one block of 4 passes per
    frame, or the same time split over the frame's two calls."""
    g = traffic.geometry(spec.load_cell(CELL, root))
    series = [(0.0, 1e5), (1e5, 2e5)]
    calls, us = (2, 0.25) if split else (1, 0.5)
    device = [(s + f + c * 0.3, s + f + c * 0.3 + us, f"void (anonymous namespace)::{k}<2, 0, "
               "float>(...)") for s, _ in series for f in range(g["nz"]) for c in range(calls)
              for k in B1]
    device.append((5.0, 50.0, "Memcpy HtoD (Pageable -> Device)"))
    return g, series, device


@pytest.mark.parametrize("split", [False, True])
def test_roofline_reader_counts_the_doubled_geometry(toeplitz_root, split):
    """Each frame's frozen bound of its right side (`grid_bound`, 2 nc real
    channels on the nxos grid) plus its multiplier (readouts 1 .. nro - 1
    at the doubled radii on the 2 nxos grid, one complex channel) over B1's
    device time; the same whether that time is one call's or split over
    the frame's two.  A profile without B1, or a geometry with no
    iteration, reads None."""
    g, series, device = _roofline_case(toeplitz_root, split)
    radii2 = 2.0 * (torch.arange(1, g["nro"], dtype=torch.float64) - g["nro"] // 2)
    n2 = 2 * g["nxos"]
    want_us = 0.0
    for z in range(g["nz"]):
        a = golden_angles(g["work"], g["skip"] + z * g["slide"])
        want_us += 1e3 * roofline.grid_bound(g["work"], 2 * g["nc"], a, g["nxos"],
                                             g["kernwidth"])[0]
        nbytes = g["work"] * (g["nro"] - 1) * 8 + g["work"] * 4 + n2 * n2 * 8
        want_us += 1e3 * roofline.bound(
            nbytes, sum(roofline.work_of(radii2, a, n2, 2, g["kernwidth"])))[0]
    read = spec.metric_reader("toeplitz_grid_roofline_pct", toeplitz_root)
    got = read(tr.Trace(series, device, [], 0, g))
    assert got == pytest.approx(100.0 * 2 * want_us / (2 * g["nz"] * 4 * 0.5), rel=1e-12)
    # the doubled geometry counts: more than the right side's bound alone
    rhs_us = sum(1e3 * roofline.grid_bound(g["work"], 2 * g["nc"],
                                           golden_angles(g["work"], g["skip"] + z * g["slide"]),
                                           g["nxos"], g["kernwidth"])[0] for z in range(g["nz"]))
    assert want_us > 1.5 * rhs_us
    assert read(tr.Trace(series, device[-1:], [], 0, g)) is None
    assert read(tr.Trace(series, device, [], 0, {**g, "niter": 0})) is None


def test_tiny_traced_series_read_the_psf_span(toeplitz_root, card_route):
    """The tiny cell's series profiled as a traced run profiles them: on
    the CPU the build spans read a time, one a frame, and no B1 kernel runs
    (no device), so the share reads None."""
    from benchmark.program import Program

    cell = spec.load_cell(CELL, toeplitz_root)
    geo = traffic.geometry(cell)
    program = Program(cell.recon, cell.config["precision"], torch.device("cpu"))
    indata = traffic.make_input(geo, 2**31 + 17, torch.device("cpu"))
    n = traffic.traced_series(cell, geo)
    t = tr.reduce(tr.profile(lambda _: program.series(indata), n), geo)
    assert len(t.series) == n == 2
    assert sum(n == "tron.toeplitz_psf" for _, _, n in t.host) == 2 * 3
    assert spec.metric_reader("toeplitz_psf_ms", toeplitz_root)(t) > 0
    assert spec.metric_reader("toeplitz_grid_roofline_pct", toeplitz_root)(t) is None


@pytest.mark.gpu
def test_card_toeplitz_run_and_trace(toeplitz_root, card):
    """On the card: the tiny Toeplitz cell reads ``correct`` true under its
    limit, plain and traced, and a traced run reads both metrics, the
    share in (0, 100]."""
    cell = spec.load_cell(CELL, toeplitz_root)
    r = run.run_cell(cell, 2**31 + 43, 1.0, False, card)
    assert r["correct"] is True, r["checks"]
    r = run.run_cell(cell, 2**31 + 44, 1.0, True, card)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == set(METRICS)
    assert 0 < r["metrics"]["toeplitz_grid_roofline_pct"]["value"] <= 100
    assert r["metrics"]["toeplitz_psf_ms"]["value"] > 0
