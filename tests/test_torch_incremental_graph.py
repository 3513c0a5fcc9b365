"""The telescoping scheduler's angle table and graphed frame loop on the
CPU (`recon.recon_frames_incremental`, `recon.incremental_scan`).

Every spoke's angle comes from one table built in the sample prep, and
each step's from one row of its delta rows; both are bitwise the
`spoke_angles` calls of the slices they replace.  On the card every frame
from the third replays one CUDA graph of the step; here the capture is
stood in for (it runs its function once, as a capture runs its Python, and
a replay runs it again), so the loop's seeding, counts and order are held
to the eager scan bitwise.  The graph itself runs only on the card
(`tests/test_torch_cuda.py`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tron_tpu_torch import graphs, recon
from tron_tpu_torch.config import AngleScheme, ReconConfig
from tron_tpu_torch.trajectory import spoke_angles

torch.set_num_threads(1)

# the whole-body series: 204 spokes a frame sliding by 21, 956 frames
WORK, SLIDE, NZ = 204, 21, 956


@pytest.mark.parametrize("skip", [0, 5, 64 * SLIDE, 19000 + 37])
def test_delta_rows_are_spoke_angles(skip):
    """``skip``: skip_angles plus the scan's own offset, as a streamed
    block's 64 frames later (64 * 21 profiles) or a whole-body series'
    late one."""
    table = spoke_angles(WORK + (NZ - 1) * SLIDE, AngleScheme.GOLDEN, skip)
    rows = recon.delta_angle_rows(table, WORK, SLIDE, NZ - 1)
    assert rows.shape == (NZ - 1, 2 * SLIDE) and rows.is_contiguous()
    assert torch.equal(table[:WORK], spoke_angles(WORK, AngleScheme.GOLDEN, skip))
    for i in range(NZ - 1):
        pe0 = i * SLIDE
        want = torch.cat([spoke_angles(SLIDE, AngleScheme.GOLDEN, skip + pe0),
                          spoke_angles(SLIDE, AngleScheme.GOLDEN, skip + pe0 + WORK)])
        assert torch.equal(rows[i], want), i


def test_no_step_leaves_empty_rows():
    table = spoke_angles(WORK, AngleScheme.GOLDEN, 3)
    assert recon.delta_angle_rows(table, WORK, SLIDE, 0).shape == (0, 2 * SLIDE)


def _series(seed, nc=3, nro=64, work=25, slide=21, nz=6):
    cfg = ReconConfig(adjoint=True, golden_angle=True, data_undersamp=work / nro,
                      prof_slide=slide, skip_angles=5, incremental=True)
    npe1 = work + (nz - 1) * slide
    assert cfg.frame_geometry(nro, npe1) == (work, slide, nz)
    x = np.random.default_rng(seed).standard_normal((2, nc, npe1, nro), np.float32)
    return cfg, torch.from_numpy((x[0] + 1j * x[1]).astype(np.complex64))


@pytest.mark.parametrize("planes", [True, False])
@pytest.mark.parametrize("skip0", [0, 7, 16 * 21])
def test_scan_grids_each_slice_at_its_own_angles(monkeypatch, planes, skip0):
    """The seeded window and each delta are gridded at the angles of the
    per-slice `spoke_angles` calls the table replaces, on the plane path
    and the gather route alike; ``skip0`` as a streamed block's offset."""
    cfg, data = _series(31)
    if not planes:
        cfg = dataclasses.replace(cfg, backend="jnp")
    work, slide, nz = 25, 21, 6
    seen = []
    scan = recon.incremental_scan

    def recording(window, angles_of, gridw, *a, **k):
        def gridw_seen(win, ang):
            seen.append(ang.clone())
            return gridw(win, ang)
        return scan(window, angles_of, gridw_seen, *a, **k)

    monkeypatch.setattr(recon, "incremental_scan", recording)
    recon.recon_frames_incremental(data, cfg, work, slide, nz, skip0)
    skip = cfg.skip_angles + skip0
    assert len(seen) == nz
    assert torch.equal(seen[0], spoke_angles(work, AngleScheme.GOLDEN, skip))
    for i, ang in enumerate(seen[1:]):
        pe0 = i * slide
        want = torch.cat([spoke_angles(slide, AngleScheme.GOLDEN, skip + pe0),
                          spoke_angles(slide, AngleScheme.GOLDEN, skip + pe0 + work)])
        assert torch.equal(ang, want), i


class _Rerun:
    """A captured graph's stand-in: a replay runs the function again on the
    static tensors and leaves its image in the static output."""

    def __init__(self, fn, static, out):
        self.fn, self.static, self.out = fn, static, out

    def replay(self):
        self.out.copy_(self.fn(*self.static))


@pytest.fixture
def stand_in(monkeypatch):
    """The graphed scan on the CPU: the scheduler takes its graph branch; a
    capture runs the step once and restores the carried grid it advanced,
    as a capture launches nothing."""

    def capture(fn, static):
        kept = static[-1].clone()
        out = fn(*static)
        static[-1].copy_(kept)
        graph = _Rerun(fn, static, out)
        return graph, out

    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(recon, "_graphed", lambda t, coil_axis: True)
    monkeypatch.setattr(recon, "_incremental_graphs", graphs.Cache())
    monkeypatch.setattr(recon, "INCREMENTAL_GRAPH_COUNTS", recon._incremental_graphs.counts)
    monkeypatch.setattr(recon, "INCREMENTAL_COUNTS", dict.fromkeys(recon.INCREMENTAL_COUNTS, 0))


def test_graphed_scan_is_the_eager_scan(stand_in, monkeypatch):
    """Frames 0 and 1 eager, then one capture and nz - 2 replays, bitwise
    the eager scan; a second series of other samples in the same process
    captures nothing, reseeds the graph's carried grid and is bitwise its
    own eager scan; another slide is another graph."""
    cfg, a = _series(41)
    _, b = _series(42)
    work, slide, nz = 25, 21, 6
    got_a = recon.recon_frames_incremental(a, cfg, work, slide, nz, 3)
    assert recon.INCREMENTAL_GRAPH_COUNTS == {"captured": 1, "replayed": nz - 2, "eager": 2}
    got_b = recon.recon_frames_incremental(b, cfg, work, slide, nz, 3 + 16 * slide)
    assert recon.INCREMENTAL_GRAPH_COUNTS == {"captured": 1, "replayed": 2 * (nz - 2),
                                              "eager": 4}
    assert recon.INCREMENTAL_COUNTS == {"seeded": 2, "telescoped": 2 * (nz - 1), "direct": 0}
    assert len(recon._incremental_graphs.entries) == 1

    monkeypatch.setattr(recon, "_graphed", lambda t, coil_axis: False)
    want_a = recon.recon_frames_incremental(a, cfg, work, slide, nz, 3)
    want_b = recon.recon_frames_incremental(b, cfg, work, slide, nz, 3 + 16 * slide)
    assert recon.INCREMENTAL_GRAPH_COUNTS["eager"] == 4 + 2 * nz
    assert not torch.equal(want_a, want_b)
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)

    monkeypatch.setattr(recon, "_graphed", lambda t, coil_axis: True)
    cfg2, c = _series(43, slide=20)
    recon.recon_frames_incremental(c, cfg2, 25, 20, nz)
    assert recon.INCREMENTAL_GRAPH_COUNTS["captured"] == 2
    assert len(recon._incremental_graphs.entries) == 2


@pytest.mark.parametrize("nz", [1, 2])
def test_a_scan_of_two_frames_or_fewer_captures_nothing(stand_in, nz):
    cfg, data = _series(44, nz=nz)
    got = recon.recon_frames_incremental(data, cfg, 25, 21, nz)
    assert got.shape[0] == nz
    assert recon.INCREMENTAL_GRAPH_COUNTS == {"captured": 0, "replayed": 0, "eager": nz}


def test_cpu_scan_runs_eagerly_and_counts_its_frames():
    cfg, data = _series(45)
    recon.reset_incremental_graph_counts()
    counts = recon.INCREMENTAL_GRAPH_COUNTS
    recon.recon_frames_incremental(data, cfg, 25, 21, 6)
    assert counts == {"captured": 0, "replayed": 0, "eager": 6}
    recon.reset_incremental_graph_counts()
    assert recon.INCREMENTAL_GRAPH_COUNTS is counts and counts == dict.fromkeys(counts, 0)


def test_step_span_holds_the_replay(stand_in):
    """Under a profiler: one capture span, and ``tron.incremental_step``
    once a telescoped frame, each inside its ``tron.frame``; the eager
    step holds its gridding call, a replayed one the capture's stand-in
    rerun."""
    cfg, data = _series(46)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        recon.recon_frames_incremental(data, cfg, 25, 21, 6)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("tron."))
    names = [n for _, _, n in spans]
    assert names.count("tron.incremental_graph") == 1
    assert names.count("tron.frame") == 6 and names.count("tron.incremental_step") == 5
    frames = [(s, e) for s, e, n in spans if n == "tron.frame"]
    steps = [(s, e) for s, e, n in spans if n == "tron.incremental_step"]
    for (fs, fe), (s, e) in zip(frames[1:], steps):
        assert fs <= s and e <= fe
