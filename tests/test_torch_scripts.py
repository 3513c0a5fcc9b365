"""The port's paper pipeline and dissections (tron_tpu_torch.tools
paper_plots, floor_dissect, inc_dissect) and its three recipes
(scripts/torch_RUNME*.sh) on the CPU, at tiny sizes.

The tools' recons are held to the JAX package's on the same seeded data;
the figures render from fixture CSVs as tests/test_paper_plots.py renders
the JAX script's; the recipes are run with a stand-in `python` that records
each command, whose arguments then go through the named module's own parser.
"""

import argparse
import csv
import importlib
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.kernels.kb import kb_beta as jkb_beta
from tron_tpu.nufft import sdc_weights as jsdc
from tron_tpu.ops.grid import grid_radial2d as jgrid
from tron_tpu.recon import incremental_scan as jincremental_scan
from tron_tpu.recon import recon_frames as jrecon_frames
from tron_tpu.recon import recon_frames_incremental as jrecon_frames_incremental
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch.io import ra_write
from tron_tpu_torch.tools import floor_dissect, inc_dissect, paper_plots

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# two tiny classes in paper_plots.DATASETS' layout: a golden-angle sliding
# window, and a single linear_half frame (the linear phantom's kind)
TINY = [
    ("tiny_golden", 0.5, 2, 32, 0.5, 4, 28, True),
    ("tiny_linear", 0.7, 1, 32, 1.0, 32, 32, False),
]


def _jax_case(dataset, rng):
    """The JAX script's config, geometry and data for one class
    (scripts/paper_plots.py:77-90), drawn from rng as it draws them."""
    _, _, nc, nro, u, slide, npe1, golden = dataset
    cfg = JaxConfig(golden_angle=golden, angle_scheme=None if golden else "linear_half",
                    data_undersamp=u, prof_slide=slide, adjoint=True)
    work = cfg.npe1work(nro, npe1)
    eff_slide = slide if slide > 0 else work
    nz = max(1, 1 + (npe1 - work) // eff_slide)
    data = (rng.standard_normal((nc, npe1, nro))
            + 1j * rng.standard_normal((nc, npe1, nro))).astype(np.complex64)
    return cfg, work, eff_slide, nz, data


# -- paper_plots -------------------------------------------------------------


def test_measure_timings_csv_and_checksums_match_jax(tmp_path, monkeypatch):
    """On the CPU: the CSV has the port's columns, one row per class, and
    each class's recon checksum equals the sum of |image| of
    tron_tpu.recon.recon_frames on the same data (rtol 1e-5)."""
    monkeypatch.setattr(paper_plots, "DATASETS", TINY)
    path = tmp_path / "figs" / "timings.csv"
    rows = paper_plots.measure_timings(str(path), CPU)
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        assert reader.fieldnames == ["dataset", "frames", "card_s", "ref_gpu_s", "speedup",
                                     "card_msamples_per_s", "card", "power_limit_w"]
        written = list(reader)
    assert [r["dataset"] for r in written] == [d[0] for d in TINY]
    assert all(r["card"] == "cpu" and r["power_limit_w"] == "not measured" for r in written)
    rng = np.random.default_rng(0)
    for dataset, row, w in zip(TINY, rows, written):
        cfg, work, slide, nz, data = _jax_case(dataset, rng)
        want = float(jnp.sum(jnp.abs(jrecon_frames(jnp.asarray(data), cfg, work, slide, nz))))
        assert row["frames"] == int(w["frames"]) == nz
        assert row["checksum"] == pytest.approx(want, rel=1e-5)
        assert float(w["card_s"]) > 0 and row["event_s"] is None
        # the kernels' plain versions ran: no launch is counted on the CPU
        assert row["grid_launches"] == 0
        assert float(w["speedup"]) == pytest.approx(dataset[1] / float(w["card_s"]))


def _write_timings(path):
    rows = [
        {"dataset": "whole_body", "frames": 956, "card_s": 0.8, "ref_gpu_s": 3.28,
         "speedup": 4.1, "card_msamples_per_s": 749.0, "card": "NVIDIA H100 80GB HBM3",
         "power_limit_w": "700.00"},
        {"dataset": "optic_nerve", "frames": 17, "card_s": 0.02, "ref_gpu_s": 0.32,
         "speedup": 16.0, "card_msamples_per_s": 111.4, "card": "NVIDIA H100 80GB HBM3",
         "power_limit_w": "700.00"},
    ]
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def test_timing_bars(tmp_path):
    pytest.importorskip("matplotlib")
    _write_timings(tmp_path / "timings.csv")
    out = paper_plots.timing_bars(str(tmp_path / "timings.csv"), str(tmp_path / "bars.png"))
    assert out is not None and os.path.getsize(out) > 0
    assert paper_plots.timing_bars(str(tmp_path / "nope.csv"), str(tmp_path / "b.png")) is None


def test_ssim_table(tmp_path):
    pytest.importorskip("matplotlib")
    path = tmp_path / "metrics.csv"
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["label", "frame", "ssim_vs_xla", "nmse_vs_xla",
                                           "oracle_nrmse"])
        w.writeheader()
        w.writerow({"label": "whole_body", "frame": 400, "ssim_vs_xla": 0.999999,
                    "nmse_vs_xla": 1e-7, "oracle_nrmse": 4e-4})
    out = paper_plots.ssim_table(str(path), str(tmp_path / "tbl.png"))
    assert out is not None and os.path.getsize(out) > 0
    assert paper_plots.ssim_table(str(tmp_path / "nope.csv"), str(tmp_path / "t.png")) is None


def test_whole_body_mosaic(tmp_path):
    pytest.importorskip("matplotlib")
    nz, n = 5, 16
    img = np.random.default_rng(0).standard_normal((1, 1, n, n, nz)).astype(np.complex64)
    ra_write(img, tmp_path / "img.ra")
    out = paper_plots.whole_body_mosaic(str(tmp_path / "img.ra"), str(tmp_path / "m.png"),
                                        nframes=4)
    assert out is not None and os.path.getsize(out) > 0


# -- floor_dissect -----------------------------------------------------------


def test_floor_dissect_splits_each_wall(monkeypatch, capsys):
    """Two tiny classes on the CPU: one row each with the JSON keys, and
    wall = rtt + device + residual (each rounded to 1e-3 ms)."""
    monkeypatch.setattr(paper_plots, "DATASETS", TINY)
    monkeypatch.setattr(floor_dissect, "CLASSES", ("tiny_golden", "tiny_linear"))
    out = floor_dissect.main(["--device", "cpu"])
    assert out["device"] == "cpu" and out["rtt_ms_med"] >= 0
    assert [r["class"] for r in out["classes"]] == ["tiny_golden", "tiny_linear"]
    for r in out["classes"]:
        assert set(r) == {
            "class", "frames", "wall_ms", "rtt_ms", "device_ms", "busy_ms", "residual_ms",
            "rtt_pct", "device_pct", "busy_pct", "e2e_msamples_per_s",
            "device_msamples_per_s", "d2h_ms", "d2h_mb", "d2h_gbps",
        }
        assert r["wall_ms"] > 0 and r["busy_ms"] is None  # no card, no busy time
        assert r["wall_ms"] == pytest.approx(r["rtt_ms"] + r["device_ms"] + r["residual_ms"],
                                             abs=2e-3)
    assert [r["frames"] for r in out["classes"]] == [4, 1]
    # the (nz, n, n) complex64 images of nro 32
    assert out["classes"][0]["d2h_mb"] == pytest.approx(4 * 16 * 16 * 8 / 1e6, abs=5e-4)
    # the last line printed is the JSON
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"device": "cpu"')


# -- inc_dissect -------------------------------------------------------------


def test_inc_dissect_matches_jax(monkeypatch):
    """DISSECT_FRAMES=4, DISSECT_NRO=64 on the CPU: the JSON keys; the full
    path's frames vs tron_tpu.recon.recon_frames_incremental (worst frame
    <= 1e-5 NRMSE); the grid-only checksums per frame vs
    tron_tpu.recon.incremental_scan with the same windows, angles, the plain
    gridder and the checksum epilogue (rtol 1e-5)."""
    monkeypatch.setenv("DISSECT_FRAMES", "4")
    monkeypatch.setenv("DISSECT_NRO", "64")
    out = inc_dissect.main(["--device", "cpu"])
    assert set(out) == {"frames", "device", "power_limit", "full_s", "full_event_s",
                        "grid_only_s", "grid_only_event_s", "epi_only_s", "epi_only_event_s",
                        "full_msps"}
    assert out["frames"] == 4 and out["full_event_s"] is None
    assert min(out["full_s"], out["grid_only_s"], out["epi_only_s"]) > 0

    case = inc_dissect.make_case(4, 64, CPU)
    jcfg = JaxConfig(golden_angle=True, data_undersamp=0.4, prof_slide=21, adjoint=True)
    work = jcfg.npe1work(64, 10**9)
    assert (case.work, case.nxos) == (work, 64) and 0 < 21 < work
    d = jnp.asarray(case.data.numpy())

    got = inc_dissect.full(case).numpy()
    want = np.asarray(jrecon_frames_incremental(d, jcfg, work, 21, 4))
    assert got.shape == want.shape == (4, 32, 32)
    assert max(nrmse(got[z], want[z]) for z in range(4)) <= 1e-5

    beta = jkb_beta(jcfg.kernwidth, jcfg.gridos, jcfg.beatty)
    src = d * jsdc(jcfg, 64, work).astype(d.dtype)

    def window(pe0, m):
        return jax.lax.dynamic_slice_in_dim(src, pe0, m, axis=-2)

    def angles_of(pe0, m):
        return jangles(m, "golden", pe0)

    def gridw(win, ang):
        return jgrid(win, ang, 64, jcfg.kernwidth, beta)

    def frame_image(kg):
        return jnp.abs(kg[..., 0, :]).sum()

    want_g = np.asarray(jincremental_scan(window, angles_of, gridw, frame_image, work, 21, 4,
                                          spoke_axis=-2))
    got_g = inc_dissect.grid_only(case).numpy()
    assert got_g.shape == want_g.shape == (4,)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5)
    assert float(inc_dissect.epi_only(case)) > 0


# -- every tool needs the card unless the CPU is asked for ---------------------


@pytest.mark.parametrize("tool,argv", [
    (paper_plots, ["--measure"]),
    (floor_dissect, []),
    (inc_dissect, []),
])
def test_tools_need_the_card_unless_cpu_is_asked(tmp_path, monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DISSECT_FRAMES", "2")
    monkeypatch.setenv("DISSECT_NRO", "32")
    timings = tmp_path / "t.csv"
    extra = ["--timings", str(timings)] if tool is paper_plots else []
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        tool.main(argv + extra)
    assert not timings.exists()


def test_paper_plots_main_measures_without_matplotlib(tmp_path, monkeypatch, capsys):
    """On a machine without matplotlib (the card's) `--measure` writes the
    timings and draws nothing."""
    monkeypatch.setattr(paper_plots, "DATASETS", TINY[1:])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    paper_plots.main(["--measure", "--device", "cpu", "--timings", "t/timings.csv"])
    assert os.listdir(tmp_path) == ["t"] and os.listdir(tmp_path / "t") == ["timings.csv"]
    assert "figures left out" in capsys.readouterr().out


def test_compare_recon_leaves_out_figures_without_matplotlib(tmp_path, monkeypatch):
    """The card's machine has no matplotlib: RUNME2's compare_recon still
    writes its table there, and leaves the figures out."""
    from tron_tpu_torch.tools import compare_recon

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows = compare_recon.main(["--n", "16", "--npe", "8", "--device", "cpu",
                               "--out", str(tmp_path)])
    assert [r["method"] for r in rows] == ["tron-jnp", "oracle"]
    assert sorted(os.listdir(tmp_path)) == ["compare_n16_npe8.csv"]


# -- the recipes ---------------------------------------------------------------

RECIPES = ["torch_RUNME1_tron_degrid_phantom.sh", "torch_RUNME2_compare_degrid.sh",
           "torch_RUNME3_tron_grid_all.sh"]


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_parses(recipe):
    subprocess.run(["sh", "-n", os.path.join(REPO, "scripts", recipe)], check=True)


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_names_only_the_port(recipe):
    """No line names a module of the JAX package or a Python script of
    scripts/ (the JAX recipe a file counters is named by its .sh)."""
    with open(os.path.join(REPO, "scripts", recipe)) as fh:
        for ln in fh:
            assert not re.search(r"\btron_tpu\.", ln), ln
            assert not re.search(r"scripts/\S*\.py", ln), ln


def _recorded_commands(tmp_path, recipe):
    """Run the recipe with a stand-in `python` first on PATH that records
    its arguments and exits 0 (so every fixture is missing and every step
    runs, the full-scale section included); the recorded argument lists."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "calls.log"
    shim = bindir / "python"
    shim.write_text("#!/bin/sh\n"
                    "for a in \"$@\"; do printf '%s\\037' \"$a\"; done >> \"$SHIM_LOG\"\n"
                    "printf '\\036' >> \"$SHIM_LOG\"\n")
    shim.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               SHIM_LOG=str(log), TRON_OUT=str(tmp_path / "out"))
    env.pop("TRON_FULLSCALE", None)
    subprocess.run(["sh", os.path.join(REPO, "scripts", recipe)], env=env, check=True,
                   capture_output=True, timeout=60)
    assert (tmp_path / "out").is_dir()
    return [rec.split("\037")[:-1] for rec in log.read_text().split("\036")[:-1]]


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_commands_run_the_port_and_parse(tmp_path, monkeypatch, recipe):
    """Every command a recipe runs is `python -m tron_tpu_torch...`, and the
    module's own parser accepts its arguments, every one of them."""
    calls = _recorded_commands(tmp_path, recipe)
    assert len(calls) == {"torch_RUNME1_tron_degrid_phantom.sh": 2,
                          "torch_RUNME2_compare_degrid.sh": 2,
                          "torch_RUNME3_tron_grid_all.sh": 28}[recipe]
    orig = argparse.ArgumentParser.parse_known_args
    depth = [0]

    def spy(self, args=None, namespace=None):
        # stop at the outermost parse (ra_tool's subcommands parse within it)
        depth[0] += 1
        try:
            ns, rest = orig(self, args, namespace)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            raise _Parsed(ns, rest)
        return ns, rest

    monkeypatch.setattr(argparse.ArgumentParser, "parse_known_args", spy)
    for argv in calls:
        assert argv[0] == "-m" and argv[1].startswith("tron_tpu_torch."), argv
        module = importlib.import_module(argv[1])
        with pytest.raises(_Parsed) as parsed:
            module.main(argv[2:])
        assert parsed.value.args[1] == [], argv
    flags = {a for argv in calls for a in argv if a.startswith("-")}
    if recipe.startswith("torch_RUNME3"):
        assert {"--stream", "--half", "--oracle", "--csv", "--scheme"} <= flags
