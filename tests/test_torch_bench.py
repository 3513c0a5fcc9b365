"""The port's benchmark (`python -m tron_tpu_torch.bench`) on the CPU: the
smoke run of its twelve sections, a failing section, the stream fixture it
builds, parity with the JAX package on the very inputs the bench makes, the
whole-body JAX golden, and the bound helpers of `tools/roofline.py`.

`tests/data/torch_bench_golden.npz` holds the float32 sum-of-squares
magnitude of section 3's whole-body phantom frame as JAX's jnp path computes
it on the CPU; the bench on the card reports its anchor against it.
Regenerate it from the repo root with `python -m tests.test_torch_bench`.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.nufft import nufft_adjoint as jadjoint
from tron_tpu.nufft import nufft_forward as jforward
from tron_tpu.phantom import birdcage_sensitivities, shepp_logan
from tron_tpu.recon import recon_frames as jrecon_frames
from tron_tpu.recon import recon_frames_incremental as jrecon_frames_incremental
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch import bench
from tron_tpu_torch.tools import roofline
from tron_tpu_torch.trajectory import spoke_angles

torch.set_num_threads(1)

CPU = torch.device("cpu")

# each section's keys, as bench.py names them
SECTION_KEYS = {
    "throughput": ["value", "vs_baseline", "frames_per_s", "frames", "seconds_per_run",
                   "direct_bound_ms", "direct_roofline_pct"],
    "incremental": ["incremental_msamples_per_s", "nrmse_incremental_vs_direct",
                    "direct_msamples_per_s", "headline_mode"],
    "accuracy": ["nrmse_bf16_vs_fp32", "nrmse_accurate_vs_fp32"],
    "accurate_throughput": ["accurate_msamples_per_s", "accurate_frames"],
    "koosh": ["koosh_slices_per_s", "koosh_slices_per_s_e2e", "koosh_slices_per_s_e2e_half",
              "koosh_s_lo", "koosh_s_hi"],
    "degrid": ["degrid_msamples_per_s", "degrid_frames"],
    "osf": ["adjoint_msamples_per_s_osf15", "adjoint_msamples_per_s_osf25",
            "degrid_msamples_per_s_osf15", "degrid_msamples_per_s_osf25"],
    "kw3": ["adjoint_msamples_per_s_kw3"],
    "cgnr_cost": ["cgnr_pair_s_per_iter", "cgnr_toeplitz_s_per_iter", "cgnr_pair_s_lo",
                  "cgnr_pair_s_hi", "cgnr_toeplitz_s_lo", "cgnr_toeplitz_s_hi"],
    "cgnr_series": [f"cgnr_series_{m}_{k}" for m in ("adjoint", "pair", "toeplitz")
                    for k in ("wall_s", "nrmse_truth")] + ["cgnr_series_frames"],
    "walsh_cost": ["walsh_ms_per_frame", "walsh_s_lo", "walsh_s_hi"],
    "stream_wall": ["stream_wall_s", "stream_wall_s_all", "stream_wall_compress3_s",
                    "stream_wall_compress3_s_all", "stream_fixture", "stream_frames"],
}


def run_bench(argv):
    """bench.main(argv) -> (exit code, its stdout lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def smoke():
    rc, lines = run_bench(["--smoke", "--device", "cpu"])
    return rc, lines, json.loads(lines[-1])


def test_smoke_prints_one_json_line_and_exits_0(smoke):
    rc, lines, r = smoke
    assert rc == 0
    assert len(lines) == 1
    assert r["errors"] == {}
    assert (r["metric"], r["unit"], r["platform"], r["mode"]) == (
        "gridding_throughput_whole_body", "Msamples/s/chip", "cpu", "smoke")
    assert list(r["sections"]) == [name for name, _ in bench.SECTIONS] == list(SECTION_KEYS)
    assert r["vs_baseline"] == pytest.approx(r["value"] / 183.0)


@pytest.mark.parametrize("section", list(SECTION_KEYS))
def test_smoke_section_keys_and_route(smoke, section):
    """Every key of the section is there; on the CPU its operators take the
    plain versions, and no kernel is launched."""
    r = smoke[2]
    missing = [k for k in SECTION_KEYS[section] if r.get(k) is None]
    assert not missing
    s = r["sections"][section]
    assert s["route"] == "plain"
    assert set(s["precision"]) <= {"float32"}
    assert set(s["launches"]) == {"grid_radial2d", "grid_radial2d_batched",
                                  "grid_seg_radial2d", "degrid_radial2d"}
    assert not any(s["launches"].values())


def test_stream_section_builds_its_fixture(smoke):
    r = smoke[2]
    assert r["stream_fixture_built"].startswith("tools.make_goldenangle --nc 2 --nro 64 --npe 67")
    assert r["stream_frames"] == bench.SMOKE.frames
    assert len(r["stream_wall_s_all"]) == len(r["stream_wall_compress3_s_all"]) == 1


def test_failing_section_lands_in_errors_and_exits_1(monkeypatch):
    def boom(b):
        raise RuntimeError("section made to fail")

    monkeypatch.setattr(bench, "SECTIONS", (("boom", boom), ("walsh_cost", bench.walsh_cost)))
    rc, lines = run_bench(["--smoke", "--device", "cpu"])
    r = json.loads(lines[-1])
    assert rc == 1
    assert r["errors"] == {"boom": "RuntimeError: section made to fail"}
    assert r["walsh_ms_per_frame"] is not None  # the next section still ran
    assert list(r["sections"]) == ["boom", "walsh_cost"]


def test_smoke_runs_with_jax_blocked():
    """The bench, every section of it, imports nothing of JAX or tron_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tron_tpu'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from tron_tpu_torch import bench\n"
        "rc = bench.main(['--smoke', '--device', 'cpu'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tron_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "sys.exit(rc)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1])["errors"] == {}


def _jax_cfg(**changes) -> JaxConfig:
    cfg = JaxConfig(golden_angle=True, data_undersamp=0.4, prof_slide=bench.SMOKE.slide,
                    adjoint=True, backend="jnp")
    return dataclasses.replace(cfg, **changes)


def _jax_anchor(shapes):
    """JAX's section-3 anchor: the phantom through its jnp forward, then its
    jnp adjoint (`bench.py:295-306`), coil images (nc, n, n)."""
    n = shapes.nro // 2
    cfg = _jax_cfg(prof_slide=shapes.slide)
    angles = jangles(bench.work_of(shapes), "golden", 0)
    img = jnp.asarray(shepp_logan(n)[None] * birdcage_sensitivities(n, shapes.nc))
    return np.asarray(jadjoint(jforward(img, angles, cfg, nro=shapes.nro), angles, cfg))


def _parity(section):
    """(the port's output, JAX's) for a section, on the bench's own inputs."""
    s = bench.SMOKE
    if section in ("throughput", "incremental"):
        case = bench.frames_case(s, s.frames, CPU)
        images, jframes = {
            "throughput": (bench.direct_images, jrecon_frames),
            "incremental": (bench.incremental_images, jrecon_frames_incremental),
        }[section]
        want = jframes(jnp.asarray(case.data.numpy()), _jax_cfg(), case.work, case.slide, case.nz)
        return images(case).numpy(), np.asarray(want)
    if section == "degrid":
        n, work = s.nro // 2, bench.work_of(s)
        imgs = bench.random_images((s.frames, s.nc, n, n), CPU, bench.SEED)
        angles = jangles(work, "golden", 0)
        want = [jforward(jnp.asarray(im), angles, _jax_cfg(), nro=s.nro) for im in imgs.numpy()]
        return bench.forward_frames(imgs, bench.whole_body_cfg(s), work, s.nro).numpy(), np.stack(want)
    cfg, angles, data = bench.accuracy_case(s, CPU)
    return bench.anchor_images(cfg, angles, data).numpy(), _jax_anchor(s)


@pytest.mark.parametrize("section,tol", [
    ("throughput", 1e-5), ("incremental", 1e-5),
    ("degrid", 2e-4),  # degrid vs gather (tests/test_degrid_pallas.py:44)
    ("accuracy", 1e-5),
])
def test_section_matches_jax_on_the_bench_inputs(section, tol):
    got, want = _parity(section)
    assert got.shape == want.shape
    assert nrmse(got, want) <= tol


def test_whole_body_anchor_matches_the_jax_golden():
    """Section 3's float32 anchor on the CPU at whole-body size vs JAX's."""
    g = np.load(bench.GOLDEN)
    assert (int(g["nc"]), int(g["nro"]), int(g["work"])) == (6, 512, 204)
    cfg, angles, data = bench.accuracy_case(bench.FULL, CPU)
    got = bench.sos(bench.anchor_images(cfg, angles, data))
    assert got.shape == g["images"].shape == (256, 256)
    assert nrmse(got, g["images"]) <= 1e-5


def test_whole_body_frame_bound_is_17_6_mb_by_bytes():
    """One whole-body gridding frame: 204 spokes x 512 radii x 12 planes in,
    6 grids of 512^2 out: 17.6 MB, 5.25 us at 3.35 TB/s."""
    planes = torch.zeros(204, 512, 12)
    nbytes = planes.numel() * 4 + 204 * 4 + 6 * 512 * 512 * 8
    assert round(nbytes / 1e6, 1) == 17.6
    ms, by = roofline.grid_bound(planes, spoke_angles(204, "golden", 0), 512)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert round(ms * 1e3, 2) == 5.25


# chip_smoke.py's kernels line: (call, bound ms, by) as its closures gave them
# before the helpers moved, on the same shapes and angles
WB = ((204, 512, 12), 204, 19000)
CHIP_SMOKE_BOUNDS = [
    ("grid", WB, 512, {}, 0.005252905074626866),
    ("grid", WB, 512, {"passes": 3}, 0.005252905074626866),
    ("grid", WB, 512, {"passes": 1, "tc": roofline.BF16_TC_FLOPS}, 0.005252905074626866),
    ("grid", WB, 512, {"passes": 3, "tc": roofline.TF32_TC_FLOPS}, 0.005252905074626866),
    ("grid", ((12, 128, 4), 12, 5), 128, {}, 8.560238805970149e-05),
    ("grid", ((12, 128, 4), 12, 5), 128, {"passes": 3}, 8.560238805970149e-05),
    ("degrid", ((6, 512, 512), 204, 19000), 512, {}, 0.005253516417910448),
    ("degrid", ((6, 512, 512), 204, 19000), 512, {"passes": 3}, 0.005253516417910448),
    ("degrid", ((6, 512, 512), 204, 19000), 512, {"kww": 4.0}, 0.005253516417910448),
]


@pytest.mark.parametrize("op,inputs,size,kw,want", CHIP_SMOKE_BOUNDS)
def test_bounds_keep_chip_smoke_values(op, inputs, size, kw, want):
    shape, npe, skip = inputs
    angles = spoke_angles(npe, "golden", skip)
    if op == "grid":
        got = roofline.grid_bound(torch.zeros(shape), angles, size, **kw)
    else:
        got = roofline.degrid_bound(torch.zeros(shape, dtype=torch.complex64), angles, size, **kw)
    assert got == pytest.approx((want, "bytes"), rel=1e-12)


def test_whole_body_operation_count():
    """The flops a whole-body gridding frame needs (as chip_smoke.py counted
    them): 41.66 M term flops and 35.01 M KB flops at 12 planes."""
    radii = (torch.arange(512, dtype=torch.float64) - 256)[1:]
    terms, kb = roofline.work_of(radii, spoke_angles(204, "golden", 19000), 512, 12)
    assert (terms, kb) == (41659500.0, 35007840.0)
    assert roofline.bound(1.0, roofline.FP32_FLOPS) == (1e3, "operations")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    s = bench.FULL
    coils = _jax_anchor(s)
    images = np.sqrt(np.sum(np.abs(coils) ** 2, axis=0)).astype(np.float32)
    os.makedirs(os.path.dirname(bench.GOLDEN), exist_ok=True)
    np.savez(bench.GOLDEN, images=images, nc=s.nc, nro=s.nro, work=bench.work_of(s))
    print(f"wrote {bench.GOLDEN}: images {images.shape}")
