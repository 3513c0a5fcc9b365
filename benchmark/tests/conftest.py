"""Fixtures of the benchmark's tests: a copy of the benchmark's folder with
a tiny cell, `tiny.adjoint` (2 coils, 64 readouts, 3 frames of 25 spokes,
the real traffic mix and the whole-body cell's limit), for runs on the CPU.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
TINY = {"nc": 2, "nro": 64, "npe1": 74, "work": 25, "slide": 21, "nz": 3}


def make_tiny_root(dest: Path, traced_msamples: float = 0.015) -> Path:
    """``dest``/benchmark: the benchmark's files plus the tiny cell, whose
    traced runs profile two series; ``dest``/BENCHMARK.json lists it."""
    root = dest / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = {**json.loads((root / "configs" / "whole_body.json").read_text()), **TINY,
           "name": "tiny"}
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    traffic = json.loads((root / "traffic" / "adjoint.json").read_text())
    traffic["traced_msamples"] = traced_msamples
    (root / "traffic" / "tinyadjoint.json").write_text(json.dumps(traffic))
    spec["workloads"].append({"name": "tiny.adjoint", "config": "tiny", "traffic": "tinyadjoint",
                              "chips": 1, "why": "test"})
    shutil.copy(root / "limits" / "whole_body.adjoint.json", root / "limits" / "tiny.adjoint.json")
    for m in spec["per_layer"]:
        m["workloads"].append("tiny.adjoint")
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
