"""The CGNR frame's scheduler half and the card's idle time by span
(`idle.py`, `metrics/cgnr_sched_host_ms.py`, `cgnr_sched_launches_per_frame.py`,
`cgnr_sched_idle_pct.py`, `cgnr_solve_idle_pct.py`): each reader's number
from a synthetic trace and None without its spans; each gap put down to
its innermost span and class, the classes summing to the gaps; the tiny
CGNR cells' traced CPU runs read the host-time reader.

`BENCHMARK.json` lists none of the four yet: `test_bench_cgnr.py` and
`test_bench_toeplitz.py` hold each CGNR cell to its exact set of metrics,
so the entries (``ENTRIES``) come with a change that widens those sets.
The tiny cells here list them in their own copy."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import idle, spec, traffic
from benchmark import trace as tr
from benchmark.tests.test_bench_cgnr import make_cgnr_root
from benchmark.tests.test_bench_toeplitz import make_toeplitz_root

METRICS = ("cgnr_sched_host_ms", "cgnr_sched_launches_per_frame", "cgnr_sched_idle_pct",
           "cgnr_solve_idle_pct")
WINDOW = (0.0, 10_000.0)
# the four readers' per_layer entries, but for their cells
ENTRIES = [
    {"name": "cgnr_sched_host_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "frame scheduler, CGNR half, recon.reconstruct_frame", "moves": "msamples_per_s"},
    {"name": "cgnr_sched_launches_per_frame", "unit": "launches/frame", "better": "lower",
     "source": "device_trace",
     "layer": "frame scheduler, CGNR half, recon.reconstruct_frame", "moves": "msamples_per_s"},
    {"name": "cgnr_sched_idle_pct", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "msamples_per_s"},
    {"name": "cgnr_solve_idle_pct", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "msamples_per_s"},
]


def _frame(t0: float) -> list:
    """One CGNR frame's spans and launch calls from ``t0``, times in us:
    angles (one launch), the solve (right side, two iterations: three
    launches), the combine (two) and the write (one)."""
    return [
        (t0, t0 + 1000, "tron.frame"),
        (t0, t0 + 100, "tron.angles"), (t0 + 20, t0 + 21, "cudaLaunchKernel"),
        (t0 + 50, t0 + 90, "cudaStreamSynchronize"),
        (t0 + 100, t0 + 800, "tron.cgnr"),
        (t0 + 110, t0 + 200, "tron.cgnr_rhs"), (t0 + 120, t0 + 121, "cudaGraphLaunch"),
        (t0 + 200, t0 + 500, "tron.cgnr_iter"), (t0 + 210, t0 + 211, "cudaGraphLaunch"),
        (t0 + 500, t0 + 780, "tron.cgnr_iter"), (t0 + 510, t0 + 511, "cudaGraphLaunch"),
        (t0 + 800, t0 + 900, "tron.combine"), (t0 + 810, t0 + 811, "cudaLaunchKernel"),
        (t0 + 820, t0 + 821, "cuLaunchKernel"),
        (t0 + 950, t0 + 951, "cudaLaunchKernel"),
    ]


# the profiler's own stalls: in the second frame's last iteration and its combine
STALLS = [(1610.0, 1650.0, "Buffer Flush"), (1900.0, 1930.0, "Activity Buffer Request")]


# one series: the upload's launch, two frames, the readback
HOST = ([(0.0, 60.0, "tron.upload"), (40.0, 41.0, "cudaLaunchKernel")] + _frame(100.0)
        + _frame(1100.0) + STALLS + [(2100.0, 2600.0, "tron.readback"),
                                     (2350.0, 2351.0, "cudaLaunchKernel")])
# the card's idle stretches, each with the span it opens in and its class
GAPS = [
    ((0.0, 30.0), "tron.upload", "other"),
    ((100.0, 110.0), "tron.angles", "scheduler"),     # opens as the frame and its angles do
    ((150.0, 180.0), "tron.angles", "scheduler"),
    ((350.0, 400.0), "tron.cgnr_iter", "solve"),
    ((950.0, 960.0), "tron.combine", "scheduler"),
    ((1050.0, 1080.0), "tron.frame", "scheduler"),    # the first frame's write
    ((1205.0, 1215.0), "tron.cgnr", "solve"),
    ((1230.0, 1260.0), "tron.cgnr_rhs", "solve"),
    ((1620.0, 1640.0), "tron.cgnr_iter", "other"),    # opens as the profiler flushes
    ((1905.0, 1925.0), "tron.combine", "other"),      # opens in a buffer request
    ((2300.0, 2400.0), "tron.readback", "other"),
    ((2700.0, 2800.0), None, "other"),
    ((9000.0, 10_000.0), None, "other"),
]


def _trace(host=HOST, gaps=tuple(g for g, _, _ in GAPS), nz=2):
    """One series over WINDOW whose device is busy but for ``gaps``."""
    edges = [WINDOW[0]] + [x for g in sorted(gaps) for x in g] + [WINDOW[1]]
    device = [(edges[k], edges[k + 1], "kernel") for k in range(0, len(edges), 2)
              if edges[k + 1] > edges[k]]
    launches = sum(n in tr.LAUNCH_CALLS for _, _, n in host)
    return tr.Trace([WINDOW], device, list(host), launches, {"nz": nz})


def _by_class() -> dict:
    out = dict.fromkeys(idle.CLASSES, 0.0)
    for (g0, g1), _, cls in GAPS:
        out[cls] += g1 - g0
    return out


WANT = {
    # (2 x 1000 frame - 2 x 700 solve) us over 2 frames
    "cgnr_sched_host_ms": 0.3,
    # 7 launches a frame, 3 of them in its solve
    "cgnr_sched_launches_per_frame": 4.0,
    "cgnr_sched_idle_pct": 100.0 * _by_class()["scheduler"] / 10_000,
    "cgnr_solve_idle_pct": 100.0 * _by_class()["solve"] / 10_000,
}


def test_synthetic_trace_has_the_gaps_it_is_built_with():
    assert _trace().gaps() == sorted(g for g, _, _ in GAPS)


@pytest.mark.parametrize("name", METRICS)
def test_reader_on_a_synthetic_trace(name):
    assert spec.metric_reader(name)(_trace()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", METRICS)
def test_reader_is_none_without_its_spans(name):
    """Without the port's spans, or with frames that hold no solve (the
    direct adjoint's), every reader reads None; the launch reader also
    without launch calls, the idle readers also without the device."""
    read = spec.metric_reader(name)
    assert read(_trace([h for h in HOST if not h[2].startswith("tron.")])) is None
    assert read(_trace([h for h in HOST if h[2] != "tron.cgnr"])) is None
    assert read(_trace([])) is None
    if name == "cgnr_sched_launches_per_frame":
        assert read(_trace([h for h in HOST if h[2] not in tr.LAUNCH_CALLS])) is None
    if name.endswith("idle_pct"):
        bare = _trace()
        bare.device = []
        assert read(bare) is None


def test_each_gap_goes_to_its_innermost_span():
    """A gap that opens inside `tron.angles` goes to the scheduler, one inside
    `tron.cgnr_iter` to the solve, one inside `tron.readback` to other; of
    the spans that hold its start, the last to start names it."""
    got = idle.innermost(_trace())
    assert [(g0, g1) for g0, g1, _ in got] == sorted(g for g, _, _ in GAPS)
    want = {g: name for g, name, _ in GAPS}
    assert {(g0, g1): span and span[2] for g0, g1, span in got} == want


def test_classes_sum_to_the_gaps():
    t = _trace()
    got = idle.split(t)
    assert got == pytest.approx(_by_class(), rel=1e-12)
    assert sum(got.values()) == sum(g1 - g0 for g0, g1 in t.gaps())
    assert (got["solve"], got["scheduler"], got["other"]) == (90.0, 80.0, 1270.0)


def test_profiler_stalls_go_to_other():
    """Without the profiler's ops the two stalled gaps go to their spans'
    classes: the solve and the scheduler."""
    got = idle.split(_trace([h for h in HOST if h[2] not in idle.PROFILER_OPS]))
    assert (got["solve"], got["scheduler"], got["other"]) == (110.0, 100.0, 1230.0)


def test_host_split_sums_to_the_host_reader():
    """Per frame: the angles 0.1 ms, the combine 0.1, the rest (the write)
    0.1; together `cgnr_sched_host_ms`.  None without a solve."""
    t = _trace()
    got = idle.host_split(t)
    assert got == pytest.approx({"angles": 0.1, "combine": 0.1, "rest": 0.1}, rel=1e-12)
    assert sum(got.values()) == pytest.approx(
        spec.metric_reader("cgnr_sched_host_ms")(t), rel=1e-12)
    assert idle.host_split(_trace([h for h in HOST if h[2] != "tron.cgnr"])) is None


def test_launch_readers_agree():
    """The scheduler half's launch calls a frame and the solve's add up to
    all the frame's."""
    t = _trace()
    frames, solves = idle.sched_frames(t)
    starts = [s for s, _, n in t.host if n in tr.LAUNCH_CALLS]

    def inside(spans):
        return sum(s0 <= s < e0 for s in starts for s0, e0, _ in spans)

    sched = spec.metric_reader("cgnr_sched_launches_per_frame")(t)
    assert sched + inside(solves) / t.frames == inside(frames) / t.frames == 7.0


def _listing_the_readers(root, cell: str):
    """``root`` with ``ENTRIES`` listed for ``cell`` in its BENCHMARK.json."""
    path = root.parent / "BENCHMARK.json"
    s = json.loads(path.read_text())
    s["per_layer"] += [{**m, "workloads": [cell]} for m in ENTRIES]
    path.write_text(json.dumps(s))
    return root


@pytest.fixture(scope="module")
def cgnr_roots(tmp_path_factory) -> dict:
    return {
        "tiny.pair": _listing_the_readers(make_cgnr_root(tmp_path_factory.mktemp("pair")),
                                          "tiny.pair"),
        "tiny.toeplitz": _listing_the_readers(
            make_toeplitz_root(tmp_path_factory.mktemp("toeplitz")), "tiny.toeplitz"),
    }


def test_entries_keep_to_the_schema():
    """Each entry as `test_bench_discovery.py` holds the listed ones, and
    named after its reader."""
    for m in ENTRIES:
        assert set(m) | {"workloads"} == {"name", "unit", "better", "source", "layer", "moves",
                                          "workloads"}
        assert callable(spec.metric_reader(m["name"]))
    assert tuple(m["name"] for m in ENTRIES) == METRICS == idle.READERS


@pytest.mark.parametrize("cell_name", ["tiny.pair", "tiny.toeplitz"])
def test_tiny_traced_series_read_the_scheduler_half(cgnr_roots, cell_name):
    """The tiny CGNR cells' series profiled as a traced run profiles them:
    on the CPU each frame holds one `tron.angles`, one `tron.cgnr` and one
    `tron.combine`, the scheduler half's host time reads above 0, and the
    three device readers read None (no launch, no device)."""
    from benchmark.program import Program

    root = cgnr_roots[cell_name]
    cell = spec.load_cell(cell_name, root)
    assert {m["name"] for m in cell.per_layer} >= set(METRICS)
    geo = traffic.geometry(cell)
    program = Program(cell.recon, cell.config["precision"], torch.device("cpu"))
    indata = traffic.make_input(geo, 2**31 + 29, torch.device("cpu"))
    n = traffic.traced_series(cell, geo)
    t = tr.reduce(tr.profile(lambda _: program.series(indata), n), geo)
    assert len(t.series) == n == 2
    for name in ("tron.frame", "tron.angles", "tron.cgnr", "tron.combine"):
        assert sum(h[2] == name for h in t.host) == t.frames == 2 * geo["nz"], name
    assert spec.metric_reader("cgnr_sched_host_ms", root)(t) > 0
    for name in METRICS[1:]:
        assert spec.metric_reader(name, root)(t) is None, name


def test_idle_cli_reads_a_tiny_cell_on_the_cpu(cgnr_roots, capsys):
    """`python -m benchmark.idle` on the CPU: the host split of the
    scheduler half, which sums to the host reader, and no device split."""
    assert idle.main(["--workload", "tiny.toeplitz", "--seed", str(2**32 + 31)],
                     root=cgnr_roots["tiny.toeplitz"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["device"] == "cpu" and got["series"] == 2
    assert got["idle_pct"] is None and got["idle_pct_by_class"] is None
    assert min(got["host_ms_per_frame"].values()) > 0
    assert sum(got["host_ms_per_frame"].values()) == pytest.approx(
        got["metrics"]["cgnr_sched_host_ms"], rel=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", ["tiny.pair", "tiny.toeplitz"])
def test_card_trace_reads_the_scheduler_half(cgnr_roots, card, cell_name):
    """On the card a traced run of the tiny CGNR cells reads all four, the
    launch count a whole number of calls over the frames, the two idle
    shares within the run's own."""
    from benchmark import run

    cell = spec.load_cell(cell_name, cgnr_roots[cell_name])
    r = run.run_cell(cell, 2**31 + 43, 1.0, True, card)
    assert r["correct"] is True, r["checks"]
    got = {k: r["metrics"][k]["value"] for k in METRICS}
    assert got["cgnr_sched_host_ms"] > 0 and got["cgnr_sched_launches_per_frame"] > 0
    idle_pct = 100.0 * (1 - r["device"]["busy_s"] / r["device"]["window_s"])
    assert 0 <= got["cgnr_sched_idle_pct"] + got["cgnr_solve_idle_pct"] <= idle_pct + 1e-9
