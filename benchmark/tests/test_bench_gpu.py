"""On the card: the tiny cell through the kernels at the bfloat16 class
reads ``correct`` true under the whole-body cell's limit, plain and
traced.  Skips without a card."""

from __future__ import annotations

import pytest

from benchmark import run, spec

pytestmark = pytest.mark.gpu


def test_card_run_is_correct(tiny_root, card):
    cell = spec.load_cell("tiny.adjoint", tiny_root)
    r = run.run_cell(cell, 2**31 + 5, 1.0, False, card)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


def test_card_trace_reads_its_metrics(tiny_root, card):
    cell = spec.load_cell("tiny.adjoint", tiny_root)
    r = run.run_cell(cell, 2**31 + 6, 1.0, True, card)
    assert r["correct"] is True
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
