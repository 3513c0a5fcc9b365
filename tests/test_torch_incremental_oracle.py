"""The port's telescoping sliding-window scheduler (`tron -a -G
--incremental`, `recon.incremental_scan`) against the benchmark's plain
reference, `benchmark/reference/incremental.py`, which grids each frame's
own window from scratch, on the CPU over a long series: 2 coils, 64
readouts, frames of 24 spokes sliding by 3, 120 frames, seeded complex
Gaussian samples.  Also the scheduler's counters and its step span.

Tolerances, relative L2 per frame:

- ``TOL`` 1e-5: the port's carried grid after up to 119 deltas against
  the reference's frame gridded whole.  Both compute in float32, the port
  with KB weights and positions in float32 and the reference in float64,
  and the port's grid sums the frame's spokes over many calls (each delta
  scaled from its own 1/(nxos 2 slide) to the frame's 1/(nxos work)); the
  frames read ~1e-6.  The reference with its gridding operands rounded to
  bfloat16 reads ~1e-3 and fails it.
- ``DRIFT`` 4: the last ten frames' worst error over the first ten's.
  Rounding in the carried grid grows with the steps taken; a repaired or
  sound accumulation keeps the two within a small factor, a scale error
  of one part in 1e4 a step (the delta's scale in float16) does not.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import incremental as reference
from tron_tpu_torch import recon
from tron_tpu_torch.config import ReconConfig

NC, NRO, WORK, SLIDE, NZ = 2, 64, 24, 3, 120
NPE1 = WORK + SLIDE * (NZ - 1)
TOL = 1e-5
DRIFT = 4.0
SETTINGS = {"adjoint": True, "golden_angle": True, "data_undersamp": WORK / NRO,
            "prof_slide": SLIDE, "gridos": 2.0, "kernwidth": 2.0, "skip_angles": 0,
            "incremental": True}


def _cfg(**kw) -> ReconConfig:
    return ReconConfig(**{**SETTINGS, **kw})


def _input(seed: int, nt: int = 1, npe1: int = NPE1) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((2, NC, nt, NRO, npe1), np.float32)
    return (x[0] + 1j * x[1]).astype(np.complex64)


def _rel(got, want) -> np.ndarray:
    """Each frame's relative L2 error; a frame that is not finite reads inf."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    dims = tuple(range(1, want.dim()))
    err = (torch.linalg.vector_norm(got - want, dim=dims)
           / torch.linalg.vector_norm(want, dim=dims)).numpy()
    return np.nan_to_num(err, nan=np.inf)


@pytest.fixture(scope="module")
def case():
    """The series, the port's frames and the reference's, float32."""
    indata = _input(2**31 + 27)
    cfg = _cfg()
    assert cfg.frame_geometry(NRO, NPE1) == (WORK, SLIDE, NZ)
    recon.reset_incremental_counts()
    got = recon.recon_radial2d(indata, cfg, device="cpu")[:, 0]
    counts = dict(recon.INCREMENTAL_COUNTS)
    ref = reference.Series(indata[:, :1], SETTINGS, "cpu")
    want = ref.frames(list(range(NZ)))
    return indata, ref, got, want, counts


def test_every_frame_matches_the_reference(case):
    _, _, got, want, _ = case
    assert got.shape == tuple(want.shape) == (NZ, NRO // 2, NRO // 2)
    assert _rel(got, want).max() <= TOL


def test_the_carried_grid_does_not_drift(case):
    """The last ten frames, 110-119 deltas into the carried grid, read
    within DRIFT of the first ten."""
    _, _, got, want, _ = case
    err = _rel(got, want)
    assert err[-10:].max() <= DRIFT * err[:10].max(), (err[:10], err[-10:])


def test_bfloat16_reference_fails_the_tolerance(case):
    _, ref, _, want, _ = case
    frames = [0, NZ // 2, NZ - 1]
    assert _rel(ref.frames(frames, "bfloat16"), want[frames]).min() > 10 * TOL


@pytest.mark.parametrize("scale", [1 + 1e-4, 1 - 1e-4])
def test_a_drifting_step_is_caught(monkeypatch, case, scale):
    """A delta scaled one part in 1e4 off, as a float16 scale would be:
    the error grows with the steps, and the drift check or the
    tolerance fails."""
    indata, _, _, want, _ = case
    scan = recon.incremental_scan

    def off(window, angles_of, gridw, frame_image, *a, **k):
        calls = {"n": 0}

        def scaled(win, ang):
            calls["n"] += 1
            g = gridw(win, ang)
            return g if calls["n"] == 1 else g * scale

        return scan(window, angles_of, scaled, frame_image, *a, **k)

    monkeypatch.setattr(recon, "incremental_scan", off)
    err = _rel(recon.recon_radial2d(indata, _cfg(), device="cpu")[:, 0], want)
    assert err.max() > TOL or err[-10:].max() > DRIFT * err[:10].max()


def test_counts_one_seeded_frame_and_the_rest_telescoped(case):
    assert case[4] == {"seeded": 1, "telescoped": NZ - 1, "direct": 0}


def test_counts_each_repetition():
    recon.reset_incremental_counts()
    recon.recon_radial2d(_input(5, nt=2, npe1=WORK + SLIDE * 9), _cfg(), device="cpu")
    assert recon.INCREMENTAL_COUNTS == {"seeded": 2, "telescoped": 2 * 9, "direct": 0}


@pytest.mark.parametrize("why", ["linear-angle", "slide-equals-work", "slide-beyond-work"])
def test_a_series_the_scheduler_cannot_take_counts_direct(why):
    """A series that asks for --incremental and fails
    `incremental_applicable` runs the direct path and counts one
    ``direct``; it seeds and telescopes nothing."""
    kw = {"linear-angle": {"golden_angle": False},
          "slide-equals-work": {"prof_slide": WORK},
          "slide-beyond-work": {"prof_slide": WORK + 5}}[why]
    cfg = _cfg(**kw)
    indata = _input(6, npe1=WORK * 4)
    recon.reset_incremental_counts()
    got = recon.recon_radial2d(indata, cfg, device="cpu")
    assert recon.INCREMENTAL_COUNTS == {"seeded": 0, "telescoped": 0, "direct": 1}
    want = recon.recon_radial2d(indata, _cfg(incremental=False, **kw), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert recon.INCREMENTAL_COUNTS["direct"] == 1


def test_a_direct_series_counts_nothing():
    recon.reset_incremental_counts()
    recon.recon_radial2d(_input(7, npe1=WORK + SLIDE * 4), _cfg(incremental=False), device="cpu")
    assert recon.INCREMENTAL_COUNTS == {"seeded": 0, "telescoped": 0, "direct": 0}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("tron."))
    return out, spans


@pytest.mark.parametrize("incremental", [True, False])
def test_step_span_once_a_telescoped_frame(incremental):
    """Under a profiler the scheduler opens ``tron.incremental_step`` once
    a telescoped frame, nz - 1 a series, each inside its frame's
    ``tron.frame``, holding the delta's one gridding call, with the
    frame's epilogue after it; the direct path opens none.  The images
    are bitwise those of the run without a profiler."""
    nz = 12
    indata, cfg = _input(8, npe1=WORK + SLIDE * (nz - 1)), _cfg(incremental=incremental)
    out, spans = _profiled(lambda: recon.recon_radial2d(indata, cfg, device="cpu"))
    np.testing.assert_array_equal(out, recon.recon_radial2d(indata, cfg, device="cpu"))
    steps = [(s, e) for s, e, n in spans if n == "tron.incremental_step"]
    frames = [(s, e) for s, e, n in spans if n == "tron.frame"]
    grids = [(s, e) for s, e, n in spans if n == "tron.grid_radial2d"]
    assert len(frames) == nz
    if not incremental:
        assert steps == []
        return
    assert len(steps) == nz - 1
    first = frames[0]
    assert not any(first[0] <= s and e <= first[1] for s, e in steps)
    for (fs, fe), (s, e) in zip(frames[1:], steps):
        assert fs <= s and e <= fe and e < fe
        assert sum(s <= gs and ge <= e for gs, ge in grids) == 1
