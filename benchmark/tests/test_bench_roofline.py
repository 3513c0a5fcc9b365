"""The benchmark's frozen roofline arithmetic against the port's copy
(`tron_tpu_torch/tools/roofline.py`) at the configuration's frame shapes,
and the gridding and degridding kernels' shares read from the geometry."""

from __future__ import annotations

import pytest
import torch

from benchmark import roofline, spec, trace, traffic
from benchmark.reference.nufft import golden_angles


@pytest.mark.parametrize("frame", [0, 100, 955])
def test_frozen_bound_equals_the_ports(frame):
    from tron_tpu_torch.tools import roofline as port

    g = traffic.geometry(spec.load_cell("whole_body.adjoint"))
    angles = golden_angles(g["work"], g["skip"] + frame * g["slide"])
    planes = torch.empty((g["work"], g["nxos"], 2 * g["nc"]))
    assert roofline.grid_bound(g["work"], 2 * g["nc"], angles, g["nxos"], g["kernwidth"]) == \
        port.grid_bound(planes, angles, g["nxos"], kww=g["kernwidth"])


def test_whole_body_frame_is_bound_by_bytes():
    """17.6 MB a whole-body frame: 5.253 us at 3.35 TB/s."""
    g = traffic.geometry(spec.load_cell("whole_body.adjoint"))
    ms, by = roofline.grid_bound(g["work"], 12, golden_angles(204, 0), 512, 2.0)
    assert by == "bytes" and ms == pytest.approx(5.253e-3, rel=1e-3)


@pytest.mark.parametrize("passes", [1, 2])
def test_grid_roofline_counts_work_from_the_geometry(tiny_root, passes):
    """The share is every frame's bound over B1's device time: gridding
    each frame twice halves it."""
    cell = spec.load_cell("tiny.adjoint", tiny_root)
    g = traffic.geometry(cell)
    bound_us = 1e3 * sum(
        roofline.grid_bound(g["work"], 2 * g["nc"], golden_angles(g["work"], g["skip"] + z * g["slide"]),
                            g["nxos"], g["kernwidth"])[0] for z in range(g["nz"]))
    series = [(0.0, 100.0), (100.0, 200.0)]
    per_frame = 4.0 * passes          # us a frame, over the four passes
    device = [(s + z, s + z + per_frame / 4, f"void {k}<float>(...)")
              for s, _ in series for z in range(g["nz"])
              for k in ("grid_tile_band_kernel", "grid_tile_items_kernel",
                        "grid_tile_contract_kernel", "grid_tile_reduce_kernel")]
    device.append((5.0, 50.0, "Memcpy HtoD (Pageable -> Device)"))
    t = trace.Trace(series, device, [], 0, g)
    got = spec.metric_reader("grid_roofline_pct", tiny_root)(t)
    assert got == pytest.approx(100.0 * 2 * bound_us / (2 * g["nz"] * per_frame), rel=1e-12)
    assert spec.metric_reader("grid_roofline_pct", tiny_root)(
        trace.Trace(series, device[-1:], [], 0, g)) is None


# a forward frame at whole-body sizes: 6 coils of 256 x 256 images at gridos 2
# onto int(0.4 x 512) = 204 spokes of 512 readouts, kernel half-width 2
FORWARD_FRAME = {"work": 204, "nc": 6, "nxos": 512, "nro": 512, "kernwidth": 2.0}


@pytest.mark.parametrize("skip", [0, 7, 20000])
def test_frozen_degrid_bound_equals_the_ports(skip):
    from tron_tpu_torch.tools import roofline as port

    g = FORWARD_FRAME
    angles = golden_angles(g["work"], skip)
    kgrid = torch.empty((g["nc"], g["nxos"], g["nxos"]), dtype=torch.complex64)
    assert roofline.degrid_bound(g["work"], g["nc"], angles, g["nxos"], g["nro"],
                                 g["kernwidth"]) == \
        port.degrid_bound(kgrid, angles, g["nro"], kww=g["kernwidth"])


def test_whole_body_sized_forward_frame_is_bound_by_bytes():
    """12.6 MB of grids in, 5.0 MB of samples out a frame of whole-body
    sizes: 5.254 us at 3.35 TB/s."""
    ms, by = roofline.degrid_bound(204, 6, golden_angles(204, 0), 512, 512, 2.0)
    assert by == "bytes" and ms == pytest.approx(5.2535e-3, rel=1e-4)


@pytest.mark.parametrize("passes", [1, 2])
def test_degrid_roofline_counts_work_from_the_geometry(tiny_root, passes):
    """The share is every frame's bound over B3's device time, its
    wrap-edge launches with it: degridding each frame twice halves it; a
    profile without B3 reads None."""
    cell = spec.load_cell("tiny.forward", tiny_root)
    g = traffic.geometry(cell)
    bound_us = 1e3 * g["nz"] * roofline.degrid_bound(
        g["work"], g["nc"], golden_angles(g["work"], g["skip"]), g["nxos"], g["nro"],
        g["kernwidth"])[0]
    series = [(0.0, 100.0), (100.0, 200.0)]
    per_frame = 3.0 * passes
    device = [(s + z, s + z + per_frame / passes,
               "void (anonymous namespace)::degrid_radial2d_kernel<4, 4, 8, 0>(...)")
              for s, _ in series for z in range(g["nz"]) for _ in range(passes)]
    device.append((5.0, 50.0, "Memcpy HtoD (Pageable -> Device)"))
    t = trace.Trace(series, device, [], 0, g)
    got = spec.metric_reader("degrid_roofline_pct", tiny_root)(t)
    assert got == pytest.approx(100.0 * 2 * bound_us / (2 * g["nz"] * per_frame), rel=1e-12)
    assert spec.metric_reader("degrid_roofline_pct", tiny_root)(
        trace.Trace(series, device[-1:], [], 0, g)) is None
