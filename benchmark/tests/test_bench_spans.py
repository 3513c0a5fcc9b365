"""The per-layer metrics that read the port's own spans (`spans.py`,
`metrics/relayout_ms.py`, `h2d_ms.py`, `d2h_ms.py`, `frame_host_ms.py`,
`grid_call_us.py`): each reads its number from a synthetic trace and None
without its span; the tiny cell's traced run reads all five; on the card
the spans and the device's copies and kernels share one clock."""

from __future__ import annotations

import pytest
import torch

from benchmark import spec, traffic
from benchmark import trace as tr

SPAN_METRICS = ("relayout_ms", "h2d_ms", "d2h_ms", "frame_host_ms", "grid_call_us")


def _trace(host, series=((0.0, 10_000.0), (20_000.0, 30_000.0)), nz=2):
    return tr.Trace(series=list(series), device=[], host=list(host), launches=0,
                    geometry={"nz": nz})


# two series of two frames: times in us
HOST = [
    (10.0, 410.0, "tron.relayout"), (410.0, 500.0, "tron.upload"),
    (500.0, 520.0, "tron.prep"),
    (520.0, 1520.0, "tron.frame"), (600.0, 700.0, "tron.grid_radial2d"),
    (1520.0, 3520.0, "tron.frame"), (1600.0, 1780.0, "tron.grid_radial2d"),
    (3520.0, 3720.0, "tron.readback"), (3530.0, 3700.0, "aten::copy_"),
    (20_010.0, 20_610.0, "tron.relayout"), (20_610.0, 20_680.0, "tron.upload"),
    (20_700.0, 21_700.0, "tron.frame"), (20_800.0, 20_880.0, "tron.grid_radial2d"),
    (21_700.0, 22_700.0, "tron.frame"), (21_800.0, 21_840.0, "tron.grid_radial2d"),
    (22_700.0, 23_000.0, "tron.readback"),
]
WANT = {"relayout_ms": (0.4 + 0.6) / 2, "h2d_ms": (0.09 + 0.07) / 2,
        "d2h_ms": (0.2 + 0.3) / 2, "frame_host_ms": 5.0 / 4, "grid_call_us": 100.0}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_on_a_synthetic_trace(name):
    read = spec.metric_reader(name)
    assert read(_trace(HOST)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_is_none_without_its_span(name):
    """A program that records no span (the parent of the port's tracing,
    say) reads None; the three per-series readers also where one series
    lacks its span."""
    read = spec.metric_reader(name)
    assert read(_trace([h for h in HOST if not h[2].startswith("tron.")])) is None
    assert read(_trace([])) is None
    if name in ("relayout_ms", "h2d_ms", "d2h_ms"):
        span = {"relayout_ms": "tron.relayout", "h2d_ms": "tron.upload",
                "d2h_ms": "tron.readback"}[name]
        assert read(_trace([h for h in HOST if h[2] != span or h[0] < 20_000])) is None


def _profiled_series(cell, device, seed, n):
    """The tiny cell's series profiled as a traced run profiles them:
    ``n`` series under the harness's span, reduced."""
    from benchmark.program import Program

    geo = traffic.geometry(cell)
    program = Program(cell.recon, cell.config["precision"], device)
    indata = traffic.make_input(geo, seed, device)
    program.series(indata)
    return tr.reduce(tr.profile(lambda _: program.series(indata), n), geo)


def test_tiny_traced_series_read_the_span_metrics(tiny_root):
    """On the CPU (where a traced run finds no device kernel and reports no
    per-layer metric) the tiny cell's profiled series read all five."""
    cell = spec.load_cell("tiny.adjoint", tiny_root)
    t = _profiled_series(cell, torch.device("cpu"), 2**31 + 11,
                         traffic.traced_series(cell, traffic.geometry(cell)))
    assert len(t.series) == 2
    assert {m["name"] for m in cell.per_layer} >= set(SPAN_METRICS)
    for name in SPAN_METRICS:
        assert spec.metric_reader(name, tiny_root)(t) > 0, name


@pytest.mark.gpu
def test_spans_share_the_device_clock(tiny_root, card):
    """On the card: the input's HtoD copy starts inside `tron.upload`, the
    images' DtoH copy inside `tron.readback`, and each frame's B1
    contraction starts after its `tron.frame` span opens."""
    cell = spec.load_cell("tiny.adjoint", tiny_root)
    t = _profiled_series(cell, card, 2**31 + 12, 1)

    def only(name):
        hits = [(s, e) for s, e, n in t.host if n == name]
        assert len(hits) == 1, (name, hits)
        return hits[0]

    def inside(x, iv):
        return iv[0] <= x <= iv[1]

    h2d = [s for s, _, n in t.device if "HtoD" in n]
    d2h = [s for s, _, n in t.device if "DtoH" in n]
    assert h2d and d2h, sorted({n for _, _, n in t.device})
    assert any(inside(s, only("tron.upload")) for s in h2d)
    assert any(inside(s, only("tron.readback")) for s in d2h)
    frames = sorted((s, e) for s, e, n in t.host if n == "tron.frame")
    contract = sorted(s for s, _, n in t.device if "grid_tile_contract_kernel" in n)
    assert len(frames) == len(contract) == t.geometry["nz"]
    for (fs, _), ks in zip(frames, contract):
        assert ks >= fs
