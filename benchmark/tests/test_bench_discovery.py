"""The benchmark finds a cell's parts by name, `BENCHMARK.json` keeps to the
schema, and a run's last line has the keys a benchmark runner reads."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run, spec, traffic
from benchmark.tests.conftest import BENCH, make_tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(entry["name"])
        assert len(entry.get("why", "x")) <= 200 and len(entry.get("source", "x")) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in e2e
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found(cell):
    c = spec.load_cell(cell)
    assert c.config["chips"] == c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "msamples_per_s"}
    assert c.per_layer and c.limits["frame_rel_err"]["limit"] > 0
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_states_its_geometry_and_flags(name):
    """The stated work, slide and frames follow from the shapes, and the
    stated flags are the recon settings as the port's CLI reads them."""
    from tron_tpu_torch.cli import build_parser

    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = json.loads((BENCH.parent / entry["file"]).read_text())
    assert cfg["source"].startswith(entry["source"])
    cell = spec.load_cell(next(w["name"] for w in SPEC["workloads"] if w["config"] == name))
    geo = traffic.geometry(cell)
    assert (geo["work"], geo["slide"], geo["nz"]) == (cfg["work"], cfg["slide"], cfg["nz"])
    args = build_parser().parse_args(cfg["flags"].split() + ["in.ra"])
    for k, v in cfg["recon"].items():
        assert getattr(args, k) == v, k


def test_discovery_of_added_files(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries are found by name, with nothing else edited."""
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    s = json.loads(json.dumps(SPEC))
    cfg = json.loads((root / "configs" / "whole_body.json").read_text())
    (root / "configs" / "other.json").write_text(json.dumps({**cfg, "nc": 3}))
    (root / "traffic" / "slow.json").write_text(json.dumps(
        {"recon": {"niter": 2}, "traced_msamples": 1, "check_frames": 2}))
    (root / "limits" / "other.slow.json").write_text(json.dumps({"frame_rel_err": {"limit": 1}}))
    (root / "metrics" / "answer.py").write_text("def read(trace):\n    return 42.0\n")
    s["configs"].append({"name": "other", "source": "x", "file": "benchmark/configs/other.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "other.slow", "config": "other", "traffic": "slow", "chips": 1,
                           "why": "x"})
    s["per_layer"].append({"name": "answer", "unit": "1", "better": "higher",
                           "source": "device_trace", "layer": "x", "moves": "msamples_per_s",
                           "workloads": ["other.slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    cell = spec.load_cell("other.slow", root)
    assert cell.config["nc"] == 3 and cell.recon["niter"] == 2
    assert cell.reference == "recon"
    assert [m["name"] for m in cell.per_layer] == ["answer"]
    assert spec.metric_reader("answer", root)(None) == 42.0
    assert traffic.traced_series(cell, traffic.geometry(cell)) == 1
    with pytest.raises(KeyError):
        spec.load_cell("other.fast", root)


def test_a_mix_names_its_reference(tmp_path):
    """A mix that names a reference module added in a temporary root is
    compared with it, with no edit to `check.py` or `run.py`: a copy of the
    adjoint's reference that doubles its frames makes the run read each
    frame 0.5 off."""
    root = make_tiny_root(tmp_path)
    src = (root / "reference" / "recon.py").read_text()
    (root / "reference" / "twice.py").write_text(
        src + "\n\n_frames = Series.frames\n"
        "Series.frames = lambda self, *a, **k: 2 * _frames(self, *a, **k)\n")
    mix = json.loads((root / "traffic" / "tinyadjoint.json").read_text())
    (root / "traffic" / "tinytwice.json").write_text(json.dumps({**mix, "reference": "twice"}))
    s = json.loads((tmp_path / "BENCHMARK.json").read_text())
    s["workloads"].append({"name": "tiny.twice", "config": "tiny", "traffic": "tinytwice",
                           "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    shutil.copy(root / "limits" / "tiny.adjoint.json", root / "limits" / "tiny.twice.json")
    cell = spec.load_cell("tiny.twice", root)
    assert Path(spec.reference(cell).__file__) == root / "reference" / "twice.py"
    r = run.run_cell(cell, 2**31 + 8, 0.2, False, torch.device("cpu"))
    assert r["correct"] is False
    assert r["checks"]["frame_rel_err"]["value"] == pytest.approx(0.5, rel=1e-4)


def test_forward_geometry_is_its_configurations_own(tiny_root):
    """A forward series takes nx and nz from its configuration and sizes
    its spokes as TRON's forward does, never from an adjoint's npe1 and
    slide; a configuration that states no nx cannot run the forward."""
    cell = spec.load_cell("tiny.forward", tiny_root)
    cell = dataclasses.replace(cell, config={**cell.config, "nx": 40, "nz": 5, "npe1": 10**6})
    geo = traffic.geometry(cell)
    assert (geo["n"], geo["nz"], geo["nro"], geo["nxos"], geo["work"], geo["npe1"],
            geo["slide"]) == (40, 5, 80, 80, 32, 32, 0)
    assert traffic.make_input(geo, 3, torch.device("cpu")).shape == (2, 1, 40, 40, 5)
    cell = dataclasses.replace(cell, config={k: v for k, v in cell.config.items() if k != "nx"})
    with pytest.raises(ValueError, match="nx"):
        traffic.geometry(cell)


# sha256 of the parent's `traffic.make_input` for the tiny adjoint geometry,
# on the CPU's generator, and of the adjoint's reference as it stands
ADJOINT_INPUT_SHA256 = {
    2**31 + 3: "7a870c595606d53949445e6eeaa292b5b9944d3cf82f94b21bbda66113625738",
    7: "486b63c580868559788cd0b0f0b44fd324c6c99195802b9917071f44053008a2"}
RECON_REFERENCE_SHA256 = "5ebece66f67d810d739e3523af3daac8d1409f564a0ae5e332e139fa88bbe931"


@pytest.mark.parametrize("seed", sorted(ADJOINT_INPUT_SHA256))
def test_adjoint_input_and_reference_are_unchanged(tiny_root, seed):
    """The adjoint's input is the same bytes, seed for seed, drawn as it
    always was (torch.randn on the generator seeded with seed mod 2**64,
    in `.ra` dims, C order), and `whole_body.adjoint` resolves to
    `reference/recon.py` as it was."""
    geo = traffic.geometry(spec.load_cell("tiny.adjoint", tiny_root))
    x = traffic.make_input(geo, seed, torch.device("cpu"))
    g = torch.Generator().manual_seed(seed % 2**64)
    want = torch.randn((2, 1, 64, 74), generator=g, dtype=torch.complex64).numpy()
    assert x.flags.c_contiguous and x.shape == want.shape
    assert x.tobytes() == want.tobytes()
    assert hashlib.sha256(x.tobytes()).hexdigest() == ADJOINT_INPUT_SHA256[seed]
    mod = spec.reference(spec.load_cell("whole_body.adjoint"))
    assert Path(mod.__file__) == BENCH / "reference" / "recon.py"
    assert hashlib.sha256(Path(mod.__file__).read_bytes()).hexdigest() == RECON_REFERENCE_SHA256


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(tiny_root, trace):
    cell = spec.load_cell("tiny.adjoint", tiny_root)
    r = run.run_cell(cell, 2**31 + 7, 0.5, trace, torch.device("cpu"))
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        for m in r["metrics"].values():
            assert m["value"] > 0 and set(m) == {"value", "unit"}
    json.loads(json.dumps(r))


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert run.main(["--workload", "whole_body.adjoint", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_check_plan_is_drawn_from_the_seed():
    cell = spec.load_cell("whole_body.adjoint")
    geo = traffic.geometry(cell)
    a, b = traffic.CheckPlan(cell, geo, 5), traffic.CheckPlan(cell, geo, 5)
    assert a.whole == b.whole and (a.frames(a.whole + 1) == b.frames(a.whole + 1)).all()
    assert len(a.frames(a.whole)) == geo["nz"] and len(a.frames(a.whole + 1)) == 8
