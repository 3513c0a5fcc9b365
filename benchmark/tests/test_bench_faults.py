"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a cell can have, and so does the control: the plain
reference at float8 in the program's place.  The harness's look for a
card is skipped; the rest of the run is the real one, on the CPU at a
tiny geometry with the cells' own limits, in either direction.  (The
cells run on one card, so no exchange between cards can be left out.)"""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import run, spec


def _run(tiny_root, name="tiny.adjoint"):
    cell = spec.load_cell(name, tiny_root)
    return run.run_cell(cell, 2**32 + 99, 0.3, False, torch.device("cpu"))


def test_sound_run_is_correct(tiny_root):
    assert _run(tiny_root)["correct"] is True


def test_sound_forward_run_is_correct(tiny_root):
    assert _run(tiny_root, "tiny.forward")["correct"] is True


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


def _degrid(monkeypatch, wrap):
    """The degridding wrapper replaced by ``wrap(orig)``."""
    from tron_tpu_torch.ops import degrid_cuda

    monkeypatch.setattr(degrid_cuda, "degrid_radial2d", wrap(degrid_cuda.degrid_radial2d))


def _half_the_coils_degridded(monkeypatch):
    """The first half of the coils degridded, their samples repeated for
    the rest."""
    def wrap(orig):
        def degrid(kgrid, *a, **k):
            half = orig(kgrid[: kgrid.shape[0] // 2], *a, **k)
            return torch.cat([half] * (kgrid.shape[0] // half.shape[0]))
        return degrid
    _degrid(monkeypatch, wrap)


def _clipped(monkeypatch):
    """Footprints clipped at the grid's edge instead of wrapped."""
    _degrid(monkeypatch, lambda orig: lambda *a, **k: orig(*a, **{**k, "wrap": False}))


def _float8_operands(monkeypatch):
    """The grid values rounded to float8 e4m3 (one scale a call) before
    the gather."""
    from benchmark.reference.nufft import rounding

    q = rounding("float8_e4m3")
    _degrid(monkeypatch, lambda orig: lambda kgrid, *a, **k: orig(q(kgrid), *a, **k))


def _no_deapodization(monkeypatch):
    """The images degridded without their deapodisation."""
    import tron_tpu_torch.nufft as N

    monkeypatch.setattr(N, "deapodize", lambda img, *a, **k: img)


def _frame_shifted_angles(monkeypatch):
    """Frame z synthesised on the angle set that starts z spokes later."""
    import tron_tpu_torch.recon as R
    from tron_tpu_torch.trajectory import spoke_angles

    at = {"z": 0}
    orig_map, orig_forward = R._map_frames, R.nufft_forward

    def map_frames(one, nz):
        def frame(z):
            at["z"] = z
            return one(z)
        return orig_map(frame, nz)

    def nufft_forward(img, angles, cfg, *a, **k):
        shifted = spoke_angles(angles.numel(), cfg.scheme_for("forward"),
                               cfg.skip_angles + at["z"], device=angles.device)
        return orig_forward(img, shifted, cfg, *a, **k)

    monkeypatch.setattr(R, "_map_frames", map_frames)
    monkeypatch.setattr(R, "nufft_forward", nufft_forward)


FAULTS = [_altered_answer, _half_the_coils, _frame_repeats]
FORWARD_FAULTS = [_altered_answer, _frame_repeats, _half_the_coils_degridded, _clipped,
                  _frame_shifted_angles, _no_deapodization, _float8_operands]


def _reads_incorrect(r):
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["frame_rel_err"]["value"] > r["checks"]["frame_rel_err"]["limit"]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_reads_incorrect(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    _reads_incorrect(_run(tiny_root))


@pytest.mark.parametrize("fault", FORWARD_FAULTS, ids=[f.__name__ for f in FORWARD_FAULTS])
def test_forward_fault_reads_incorrect(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    _reads_incorrect(_run(tiny_root, "tiny.forward"))


def _control(tiny_root, monkeypatch, name):
    """The reference the cell's mix names, at float8 e4m3, put in the
    program's place fails the cell's limit, where at float32 it passes."""
    from benchmark.program import Program

    cell = spec.load_cell(name, tiny_root)
    reference = spec.reference(cell)

    def served(quant):
        def series(self, indata):
            ref = reference.Series(indata, cell.recon, "cpu")
            return ref.frames(list(range(ref.nz)), quant).numpy()
        return series

    monkeypatch.setattr(Program, "series", served("float32"))
    assert _run(tiny_root, name)["correct"] is True
    monkeypatch.setattr(Program, "series", served("float8_e4m3"))
    assert _run(tiny_root, name)["correct"] is False


def test_control_reads_incorrect(tiny_root, monkeypatch):
    _control(tiny_root, monkeypatch, "tiny.adjoint")


def test_forward_control_reads_incorrect(tiny_root, monkeypatch):
    _control(tiny_root, monkeypatch, "tiny.forward")
