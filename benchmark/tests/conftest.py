"""Fixtures of the benchmark's tests: a copy of the benchmark's folder with
a tiny configuration (2 coils, 64 readouts, 3 frames of 25 spokes, 32 x 32
images) under the whole-body cell's traffic mix and limit, `tiny.adjoint`,
and under a forward mix, `tiny.forward`, for runs on the CPU.

`BENCHMARK.json` has no forward cell yet.  `tiny.forward` is added here as
a later forward cell would add itself: a mix naming `reference/forward.py`,
a limit, and its metrics' entries.  Its limit is the one read for a
whole-body-sized forward series on an H100 (the program's worst frame
1.667e-3 over 18 seeds, the float8 control's least 2.452e-2; PERF.md §6).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
TINY = {"nc": 2, "nro": 64, "npe1": 74, "work": 25, "slide": 21, "nz": 3, "nx": 32}
FORWARD_MIX = {"name": "forward", "why": "test", "recon": {"adjoint": False},
               "reference": "forward", "traced_msamples": 179, "check_frames": 8}
FORWARD_LIMIT = {"frame_rel_err": {"limit": 0.007}}
# the shared per-layer metrics a forward series' trace reads, and its kernel's
FORWARD_METRICS = ("host_lead_ms", "launches_per_frame", "device_idle_pct", "frame_host_ms")
DEGRID_ROOFLINE = {"name": "degrid_roofline_pct", "unit": "%", "better": "higher",
                   "source": "device_trace", "layer": "degridding kernel, ops/degrid_cuda (B3)",
                   "moves": "msamples_per_s", "workloads": ["tiny.forward"]}


def make_tiny_root(dest: Path, traced_msamples: float = 0.015) -> Path:
    """``dest``/benchmark: the benchmark's files plus the tiny cells, whose
    traced runs profile two series; ``dest``/BENCHMARK.json lists them."""
    root = dest / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = {**json.loads((root / "configs" / "whole_body.json").read_text()), **TINY,
           "name": "tiny"}
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    mixes = {"adjoint": json.loads((root / "traffic" / "adjoint.json").read_text()),
             "forward": FORWARD_MIX}
    for mix, traffic in mixes.items():
        (root / "traffic" / f"tiny{mix}.json").write_text(
            json.dumps({**traffic, "traced_msamples": traced_msamples}))
        spec["workloads"].append({"name": f"tiny.{mix}", "config": "tiny",
                                  "traffic": f"tiny{mix}", "chips": 1, "why": "test"})
    shutil.copy(root / "limits" / "whole_body.adjoint.json", root / "limits" / "tiny.adjoint.json")
    (root / "limits" / "tiny.forward.json").write_text(json.dumps(FORWARD_LIMIT))
    for m in spec["per_layer"]:
        if "whole_body.adjoint" in m["workloads"]:
            m["workloads"].append("tiny.adjoint")
        if m["name"] in FORWARD_METRICS:
            m["workloads"].append("tiny.forward")
    spec["per_layer"].append(DEGRID_ROOFLINE)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
