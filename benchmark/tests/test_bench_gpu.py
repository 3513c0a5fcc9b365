"""On the card: the tiny cells through the kernels at the bfloat16 class
read ``correct`` true under their limits (the whole-body adjoint's, and
the forward's of `conftest.py`), plain and traced, and a traced run finds
each kernel the port's counters saw.  Skips without a card."""

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


def test_card_forward_run_is_correct(tiny_root, card):
    cell = spec.load_cell("tiny.forward", tiny_root)
    r = run.run_cell(cell, 2**31 + 15, 1.0, False, card)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


def test_card_forward_trace_reads_its_metrics(tiny_root, card):
    cell = spec.load_cell("tiny.forward", tiny_root)
    r = run.run_cell(cell, 2**31 + 16, 1.0, True, card)
    assert r["correct"] is True
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < r["metrics"]["degrid_roofline_pct"]["value"] <= 100
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
