"""The port's fixture and file tools (tron_tpu_torch.tools.make_phantom,
make_goldenangle, ra_tool, tron_tpu_torch.viz, io.ra_convert) vs the JAX
package's on the CPU: the same arguments give the same files.  Then the two
comparison tools (tools.compare_recon, tools.dataset_metrics) vs
scripts/compare_recon.py and scripts/dataset_metrics.py, the multi-device
dry run (tools.dryrun_multichip, gloo ranks on the CPU) and the port's three
examples beside the JAX ones.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu import viz as jviz
from tron_tpu.io import ra_convert as jra_convert
from tron_tpu.tools import make_goldenangle as jgolden
from tron_tpu.tools import make_phantom as jphantom
from tron_tpu.tools import ra_tool as jra_tool
from tron_tpu_torch import viz
from tron_tpu_torch.io import ra_convert, ra_query, ra_read, ra_write
from tron_tpu_torch.tools import (
    compare_recon,
    dataset_metrics,
    dryrun_multichip,
    make_goldenangle,
    make_phantom,
    ra_tool,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n", [16, 32])
def test_make_phantom_bytes_equal(tmp_path, n):
    jphantom.main([str(tmp_path / "j.ra"), "--n", str(n)])
    make_phantom.main([str(tmp_path / "p.ra"), "--n", str(n)])
    assert ra_query(tmp_path / "p.ra").dims == (1, 1, n, n, 1)
    assert _bytes(tmp_path / "p.ra") == _bytes(tmp_path / "j.ra")


@pytest.mark.parametrize("argv", [["--nc", "3", "--nro", "64", "--npe", "50", "--chunk", "16"],
                                  ["--nc", "2", "--nro", "32", "--npe", "24"]])
def test_make_goldenangle_matches_jax(tmp_path, argv):
    """The forward NUFFT of the coil-weighted phantom, chunked over spokes:
    JAX's file to 1e-6 (two float32 pipelines)."""
    jgolden.main([str(tmp_path / "j.ra")] + argv)
    make_goldenangle.main([str(tmp_path / "p.ra"), "--device", "cpu"] + argv)
    want, got = ra_read(tmp_path / "j.ra"), ra_read(tmp_path / "p.ra")
    assert got.shape == want.shape == (int(argv[1]), 1, int(argv[3]), int(argv[5]), 1)
    assert got.dtype == want.dtype == np.complex64
    assert nrmse(got, want) <= 1e-6


def test_make_goldenangle_needs_the_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_goldenangle.main([str(tmp_path / "p.ra"), "--nro", "32", "--npe", "4"])
    assert not (tmp_path / "p.ra").exists()


def _fixture(tmp_path, name):
    rng = np.random.default_rng(3)
    d = (rng.standard_normal((2, 1, 4, 3, 1)) + 1j * rng.standard_normal((2, 1, 4, 3, 1)))
    p = tmp_path / name
    ra_write(d.astype(np.complex64), p)
    return p


@pytest.mark.parametrize(
    "cmd",
    [["query"], ["reshape", 6, 4], ["squash"], ["convert", "--eltype", "4", "--elbyte", "16"],
     ["half"], ["reshape", 5, 5]],
    ids=["query", "reshape", "squash", "convert", "half", "reshape-mismatch"],
)
def test_ra_tool_matches_jax(tmp_path, capsys, cmd):
    """Each subcommand on the same file through both tools: the same exit
    code, the same printed lines, the same bytes written."""
    outs, files, rcs = [], [], []
    for tool, name in ((jra_tool, "j"), (ra_tool, "p")):
        f = _fixture(tmp_path, f"{name}.ra")
        out = tmp_path / f"{name}_out.ra"
        argv = [cmd[0], str(f)] + [str(c) for c in cmd[1:]]
        if cmd[0] in ("convert", "half"):
            argv.insert(2, str(out))
        rcs.append(tool.main(argv))
        cap = capsys.readouterr()
        outs.append((cap.out, cap.err))
        files.append(_bytes(out if out.exists() else f))
    assert rcs[0] == rcs[1] == (1 if cmd == ["reshape", 5, 5] else 0)
    assert outs[0] == outs[1] and files[0] == files[1]
    if cmd[0] == "query":
        assert "type:  complex64" in outs[1][0] and "dims:  [2, 1, 4, 3, 1]" in outs[1][0]


def test_ra_tool_half_roundtrip_and_diff(tmp_path, capsys):
    f = _fixture(tmp_path, "c.ra")
    h, back = tmp_path / "h.ra", tmp_path / "back.ra"
    assert ra_tool.main(["half", str(f), str(h)]) == 0
    assert ra_query(h).dims == (2, 2, 1, 4, 3, 1) and ra_read(h).dtype == np.float16
    assert ra_tool.main(["half", str(h), str(back)]) == 0
    assert ra_tool.main(["diff", str(f), str(f)]) == 0
    assert "identical" in capsys.readouterr().out
    assert ra_tool.main(["diff", str(f), str(back)]) == 1
    assert "differ: nrmse=" in capsys.readouterr().out
    assert ra_tool.main(["diff", str(f), str(back), "--rtol", "0.01"]) == 0
    assert ra_tool.main(["diff", str(f), str(h)]) == 1
    assert "shape/dtype" in capsys.readouterr().out
    ra_write(np.zeros((2, 3), np.float32), tmp_path / "f.ra")
    assert ra_tool.main(["half", str(tmp_path / "f.ra"), str(back)]) == 1


@pytest.mark.parametrize("eltype,elbyte", [(3, 2), (3, 8), (4, 16), (1, 4)])
def test_ra_convert_matches_jax(eltype, elbyte):
    x = np.random.default_rng(eltype + elbyte).standard_normal((3, 5)).astype(np.float32) * 100
    got, want = ra_convert(x, eltype, elbyte), jra_convert(x, eltype, elbyte)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_viz_writes_pngs_like_jax(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(5)
    stack = (rng.standard_normal((5, 8, 8)) + 1j * rng.standard_normal((5, 8, 8))).astype(
        np.complex64)
    for mod, name in ((jviz, "j"), (viz, "p")):
        assert mod.mosaic(stack, str(tmp_path / f"{name}_m.png"), title="m").endswith("_m.png")
        mod.rimp(stack[0], str(tmp_path / f"{name}_r.png"))
        mod.rkmp(stack[0], str(tmp_path / f"{name}_k.png"))
        mod.compare(stack[0], stack[1], str(tmp_path / f"{name}_c.png"))
    ra_write(np.transpose(stack, (2, 1, 0))[None, None], tmp_path / "s.ra")
    png = viz.raview(str(tmp_path / "s.ra"))
    assert png == str(tmp_path / "s.ra") + ".png"
    for kind in "mrkc":
        a, b = _bytes(tmp_path / f"j_{kind}.png"), _bytes(tmp_path / f"p_{kind}.png")
        assert a[:8] == b"\x89PNG\r\n\x1a\n" and len(a) == len(b)


def test_viz_raises_without_matplotlib(tmp_path, monkeypatch):
    """matplotlib is imported at the first call; without it the call raises,
    it does not skip silently."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        viz.mosaic(np.zeros((2, 4, 4)), str(tmp_path / "m.png"))
    assert not (tmp_path / "m.png").exists()


def test_tools_are_registered():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert 'tron-torch-ra = "tron_tpu_torch.tools.ra_tool:main"' in text
    assert 'tron-torch = "tron_tpu_torch.cli:main"' in text


# -- the comparison tools --------------------------------------------------------


def _script(name, argv, cwd):
    """A script of scripts/ as the JAX package ships it: its own process."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", name), *argv],
                          capture_output=True, text=True, timeout=600, env=env, cwd=cwd)
    assert proc.returncode == 0, f"{name}: {proc.stdout}\n{proc.stderr}"
    return proc.stdout


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("golden", [False, True], ids=["linear_half", "golden"])
def test_compare_recon_matches_the_jax_script(tmp_path, golden):
    """The same methods and CSV columns as scripts/compare_recon.py, and on
    the CPU the same numbers (time_s apart): the plain gridder against the
    DTFT oracle.  The CUDA-kernel row needs the card and is said to be
    skipped."""
    pytest.importorskip("matplotlib")
    argv = ["--n", "32", "--npe", "48"] + (["--golden"] if golden else [])
    _script("compare_recon.py", argv + ["--skip-pallas", "--out", str(tmp_path / "j")], tmp_path)
    rows = compare_recon.main(argv + ["--device", "cpu", "--out", str(tmp_path / "p")])
    want, got = (_rows(tmp_path / k / "compare_n32_npe48.csv") for k in "jp")
    assert [r["method"] for r in got] == [r["method"] for r in want] == ["tron-jnp", "oracle"]
    assert list(got[0]) == list(want[0]) and len(rows) == 2
    for g, w in zip(got, want):
        for col in ("nmse_vs_ref", "nrmse_vs_ref", "ssim_vs_ref", "nrmse_vs_truth"):
            assert float(g[col]) == pytest.approx(float(w[col]), rel=1e-3, abs=1e-6), col
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))


def test_compare_recon_needs_the_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        compare_recon.main(["--n", "16", "--npe", "8", "--out", str(tmp_path / "o")])


@pytest.mark.parametrize("oracle", [False, True], ids=["plain", "oracle"])
def test_dataset_metrics_matches_the_jax_script(tmp_path, monkeypatch, oracle):
    """scripts/dataset_metrics.py and the port's tool on one fixture and one
    recon of it: the same CSV schema and, on the CPU, the same scores."""
    data, img = str(tmp_path / "ga.ra"), str(tmp_path / "img.ra")
    make_goldenangle.main([data, "--nc", "2", "--nro", "64", "--npe", "58", "--device", "cpu"])
    from tron_tpu_torch import cli

    monkeypatch.setattr(cli, "resolve_device", lambda index=0: torch.device("cpu"))
    assert cli.main(["-a", "-G", "-u", "0.5", "-d", "13", data, img]) == 0
    argv = [img, "--data", data, "--nc", "2", "-G", "-u", "0.5", "-d", "13", "--frames", "0,-1"]
    argv += ["--oracle"] if oracle else []
    _script("dataset_metrics.py", argv + ["--csv", str(tmp_path / "j.csv")], tmp_path)
    rows = dataset_metrics.main(argv + ["--csv", str(tmp_path / "p.csv"), "--device", "cpu"])
    want, got = _rows(tmp_path / "j.csv"), _rows(tmp_path / "p.csv")
    assert list(got[0]) == list(want[0]) == dataset_metrics.FIELDS
    assert [r["frame"] for r in got] == [r["frame"] for r in want] == ["0", "2"] and len(rows) == 2
    for g, w in zip(got, want):
        assert (g["oracle_nrmse"] == "") == (not oracle)
        for col in dataset_metrics.FIELDS[2:]:
            if g[col] != "":
                assert float(g[col]) == pytest.approx(float(w[col]), rel=1e-3, abs=2e-6), col
        assert float(g["nmse_vs_xla"]) < 1e-9  # the image is the plain gridder's own
    # a second run appends under the same header; an older schema is moved aside
    dataset_metrics.main(argv + ["--csv", str(tmp_path / "p.csv"), "--device", "cpu"])
    assert len(_rows(tmp_path / "p.csv")) == 4
    (tmp_path / "old.csv").write_text("label,frame\nx,0\n")
    dataset_metrics.main(argv + ["--csv", str(tmp_path / "old.csv"), "--device", "cpu"])
    assert (tmp_path / "old.csv.old").exists() and len(_rows(tmp_path / "old.csv")) == 2


# -- the dry run and the examples ----------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    """python -m tron_tpu_torch.tools.dryrun_multichip N --device cpu: the
    four checks of __graft_entry__.py:30-157 pass on every rank."""
    res = dryrun_multichip.dryrun_multichip(n, device="cpu", timeout=240.0)
    assert len(res) == n
    for r in res:
        assert r.value == ["frame x coil CGNR", "spoke-sharded CGNR",
                           "sharded incremental, skip0 7", "slice-sharded -3"]
        assert r.imported == ()


def test_dryrun_multichip_command_line(capsys):
    assert dryrun_multichip.main(["3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3 ranks (gloo" in out and "mesh frame 3 x coil 1" in out and "4 checks passed" in out


def _run_example(script, args):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # JAX's example 3 sets its own device count
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, f"{script}: {proc.stdout}\n{proc.stderr}"
    return [ln for ln in proc.stdout.splitlines() if "NRMSE" in ln]


@pytest.mark.parametrize(
    "script, args",
    [
        ("01_phantom_roundtrip.py", ["--cpu", "--n", "48", "--npe", "96"]),
        ("02_cgnr_and_coils.py", ["--cpu", "--n", "48", "--npe", "72", "--niter", "3"]),
        ("03_sharded_recon.py", ["--n", "32", "--frames", "8"]),
    ],
)
def test_torch_example_runs_and_prints_what_the_jax_one_prints(script, args):
    """As tests/test_examples.py runs the JAX examples; the port's print the
    same NRMSE lines (example 3's, whose digits are rounding noise below its
    1e-5 gate, up to that number)."""
    want = _run_example(script, args)
    got = _run_example(f"torch_{script}", args + (["--cpu"] if script.startswith("03") else []))
    assert len(got) == len(want) >= 1
    if script.startswith("03"):
        assert got[0].split("NRMSE")[0] == want[0].split("NRMSE")[0]
        assert float(got[0].rsplit(" ", 1)[1]) < 1e-5
    else:
        assert got == want
