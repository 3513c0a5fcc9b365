"""The port's one CUDA-graph mechanism on the CPU (`graphs.py`): the cache
of each user and the take-back of the kernels' launch counters around a
capture, with the capture stubbed (a graph is captured and replayed only on
the card: `tests/test_torch_cuda.py`)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from tron_tpu_torch import graphs, recon, solver
from tron_tpu_torch.ops import degrid_cuda, grid_cuda

PORT = Path(graphs.__file__).resolve().parent


def _filled(keys):
    cache = graphs.Cache()
    for k in keys:
        cache.get(k, lambda k=k: f"entry {k}")
    return cache


def test_hit_moves_its_entry_to_most_recent():
    cache = _filled(range(graphs.KEPT))
    made = []
    assert cache.get(1, lambda: made.append(1)) == "entry 1"
    assert made == []
    assert list(cache.entries) == [0, 2, 3, 1]


def test_fifth_key_evicts_the_least_recent():
    cache = _filled(range(graphs.KEPT))
    cache.get(0, lambda: "again")
    assert cache.get("new", lambda: "made") == "made"
    assert list(cache.entries) == [2, 3, 0, "new"]
    assert cache.get(1, lambda: "remade") == "remade"  # evicted, so made anew
    assert list(cache.entries) == [3, 0, "new", 1]


def test_counts_are_per_user():
    """Each user owns its cache and its counts: the frame scheduler's and
    the solver's are apart, and a reset zeroes one user's in place."""
    assert recon.FRAME_GRAPH_COUNTS is recon._frame_graphs.counts
    assert solver.CGNR_GRAPH_COUNTS is solver._cg_graphs.counts
    assert recon._frame_graphs is not solver._cg_graphs
    a, b = graphs.Cache(), graphs.Cache()
    counts = a.counts
    a.counts["captured"] += 1
    b.counts["eager"] += 2
    a.reset_counts()
    assert a.counts is counts and a.counts == {"captured": 0, "replayed": 0, "eager": 0}
    assert b.counts == {"captured": 0, "replayed": 0, "eager": 2}


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def counters(monkeypatch):
    """Both kernels' counters, set apart from the process's; a stubbed
    capture that records fn's output and launches but runs no graph."""
    monkeypatch.setattr(grid_cuda, "LAUNCH_COUNTS", dict.fromkeys(grid_cuda.KERNELS, 3))
    monkeypatch.setattr(degrid_cuda, "LAUNCHES", 5)
    monkeypatch.setattr(graphs, "_capture", lambda fn, static: (_Graph(), fn(*static)))


def _launching(x, ang):
    """What a captured chain launches: two B1 contractions, one B5, one B3."""
    grid_cuda.LAUNCH_COUNTS["grid_radial2d"] += 2
    grid_cuda.LAUNCH_COUNTS["grid_radial2d_batched"] += 1
    degrid_cuda.LAUNCHES += 1
    return x * ang


def test_capture_takes_back_both_counters_and_replay_adds_them(counters):
    chain = graphs.Chain(_launching, torch.ones(3), torch.full((3,), 2.0))
    assert grid_cuda.LAUNCH_COUNTS == dict.fromkeys(grid_cuda.KERNELS, 3)
    assert degrid_cuda.LAUNCHES == 5
    for n in (1, 2):
        chain.replay()
        assert grid_cuda.LAUNCH_COUNTS == {"grid_radial2d": 3 + 2 * n,
                                           "grid_radial2d_batched": 3 + n, "grid_seg_radial2d": 3}
        assert degrid_cuda.LAUNCHES == 5 + n and grid_cuda.LAUNCHES == 9 + 3 * n
    assert chain.graph.replays == 2


def test_replay_copies_its_inputs_into_the_static_tensors(counters):
    x, ang = torch.ones(3), torch.full((3,), 2.0)
    chain = graphs.Chain(_launching, x, ang)
    assert chain.static[0] is x and torch.equal(chain.out, torch.full((3,), 2.0))
    out = chain.replay(torch.arange(3.0), torch.full((3,), 4.0))
    assert out is chain.out
    assert torch.equal(x, torch.arange(3.0)) and torch.equal(ang, torch.full((3,), 4.0))


def test_capture_takes_back_a_users_counts_and_replay_adds_them(counters):
    """A user's own host counts (as the solver's multipliers built) are
    taken back like the launch counters: what the capture added is undone,
    and each replay adds it again."""
    built = {"nufft": 2, "exact": 7}

    def building(x, ang):
        built["nufft"] += 1
        return _launching(x, ang)

    chain = graphs.Chain(building, torch.ones(3), torch.ones(3), counts=(built,))
    assert built == {"nufft": 2, "exact": 7}
    assert grid_cuda.LAUNCH_COUNTS == dict.fromkeys(grid_cuda.KERNELS, 3)
    for n in (1, 2):
        chain.replay()
        assert built == {"nufft": 2 + n, "exact": 7}
        assert grid_cuda.LAUNCH_COUNTS["grid_radial2d"] == 3 + 2 * n


def test_failed_capture_raises_and_restores_both_counters(counters, monkeypatch):
    def failing(fn, static):
        fn(*static)
        raise RuntimeError("capture failed")

    built = {"nufft": 2}

    def building(x, ang):
        built["nufft"] += 1
        return _launching(x, ang)

    monkeypatch.setattr(graphs, "_capture", failing)
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.Chain(building, torch.ones(3), torch.ones(3), counts=(built,))
    assert grid_cuda.LAUNCH_COUNTS == dict.fromkeys(grid_cuda.KERNELS, 3)
    assert degrid_cuda.LAUNCHES == 5
    assert built == {"nufft": 2}


def _assigned_counters(tree):
    """Names of launch counters a module assigns to or updates."""
    names = set()
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "update":
            targets = [node.func.value]
        for t in targets:
            t = t.value if isinstance(t, ast.Subscript) else t
            name = t.attr if isinstance(t, ast.Attribute) else getattr(t, "id", None)
            if name in ("LAUNCHES", "LAUNCH_COUNTS"):
                names.add(name)
    return names


def test_one_module_captures_and_three_write_the_counters():
    """torch.cuda.graph and CUDAGraph appear in graphs.py alone, and no
    module but the two kernel wrappers and graphs.py writes a launch
    counter."""
    capturing, writing = set(), set()
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        src = path.read_text()
        if "torch.cuda.graph" in src or "CUDAGraph" in src:
            capturing.add(rel)
        if _assigned_counters(ast.parse(src)):
            writing.add(rel)
    assert capturing == {"graphs.py"}
    assert writing == {"graphs.py", "ops/grid_cuda.py", "ops/degrid_cuda.py"}
