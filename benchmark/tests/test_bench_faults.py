"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a cell can have, and so does the control: the plain
reference at float8 in the program's place.  The harness's look for a
card is skipped; the rest of the run is the real one, on the CPU at a
tiny geometry with the cells' own limits.  (The cells run on one card, so
no exchange between cards can be left out.)"""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import run, spec


def _run(tiny_root):
    cell = spec.load_cell("tiny.adjoint", tiny_root)
    return run.run_cell(cell, 2**32 + 99, 0.3, False, torch.device("cpu"))


def test_sound_run_is_correct(tiny_root):
    assert _run(tiny_root)["correct"] is True


def _altered_answer(monkeypatch):
    """Frame 1's image scaled by 1.1 where the frame loop stores it."""
    import tron_tpu_torch.recon as R

    def map_frames(one, nz):
        return orig(lambda z: one(z) * (1.1 if z == 1 else 1.0), nz)

    orig = R._map_frames
    monkeypatch.setattr(R, "_map_frames", map_frames)


def _half_the_coils(monkeypatch):
    """The root sum of squares over half the coils, scaled to the whole."""
    import tron_tpu_torch.recon as R

    orig = R._combine
    monkeypatch.setattr(R, "_combine", lambda img, *a, **k: orig(
        img[: img.shape[0] // 2], *a, **k) * math.sqrt(2.0))


def _frame_repeats(monkeypatch):
    """A frame step that hands on its predecessor's image unchanged."""
    import tron_tpu_torch.recon as R

    def map_frames(one, nz):
        return orig(lambda z: one(max(z - 1, 0) if z == 2 else z), nz)

    orig = R._map_frames
    monkeypatch.setattr(R, "_map_frames", map_frames)


FAULTS = [_altered_answer, _half_the_coils, _frame_repeats]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_reads_incorrect(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tiny_root)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["frame_rel_err"]["value"] > r["checks"]["frame_rel_err"]["limit"]


def test_control_reads_incorrect(tiny_root, monkeypatch):
    """The reference at float8 e4m3 put in the program's place fails the
    cell's limit, where the reference at float32 passes it."""
    from benchmark.program import Program
    from benchmark.reference.recon import Series

    recon = spec.load_cell("tiny.adjoint", tiny_root).recon

    def served(quant):
        def series(self, indata):
            ref = Series(indata, recon, "cpu")
            return ref.frames(list(range(ref.nz)), quant).numpy()
        return series

    monkeypatch.setattr(Program, "series", served("float32"))
    assert _run(tiny_root)["correct"] is True
    monkeypatch.setattr(Program, "series", served("float8_e4m3"))
    assert _run(tiny_root)["correct"] is False
