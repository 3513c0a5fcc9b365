"""The port's adjoint recon (tron_tpu_torch.nufft, .recon, .cli) vs the JAX
package on the CPU.

The main path at a small size: golden angles, nro 128, 2 coils, -u 0.4
-d 21 (51 spokes per frame, 6 frames).  Configs cross packages through
ReconConfig.from_jax_fields; inputs are numpy arrays from seeds.  On the CPU
the port's kernel wrappers take the kernel's plain version.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu import cli as jcli
from tron_tpu.config import AngleScheme
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.nufft import nufft_forward as jnufft_forward
from tron_tpu.phantom import shepp_logan
from tron_tpu.recon import recon_radial2d as jrecon
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch import cli, nufft, recon
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.io import ra_read, ra_write
from tron_tpu_torch.ops import grid_cuda

torch.set_num_threads(1)

NC, NRO, SLIDE, NZ = 2, 128, 21, 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cfg(**kw) -> JaxConfig:
    return JaxConfig(golden_angle=True, data_undersamp=0.4, prof_slide=SLIDE, adjoint=True,
                     backend="jnp", **kw)


def _port_cfg(jcfg: JaxConfig, **kw) -> ReconConfig:
    return dataclasses.replace(ReconConfig.from_jax_fields(dataclasses.asdict(jcfg)), **kw)


@pytest.fixture(scope="module")
def indata():
    """(nc, nt, nro, npe1) complex64, 6 frames of 51 spokes."""
    work = int(NRO * 0.4)
    shape = (NC, 1, NRO, work + (NZ - 1) * SLIDE)
    rng = np.random.default_rng(11)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def jax_images(indata):
    return {inc: jrecon(indata, _jax_cfg(incremental=inc)) for inc in (False, True)}


def _frame_nrmse(got, want) -> float:
    return max(nrmse(got[z], want[z]) for z in range(want.shape[0]))


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("incremental", [False, True])
def test_recon_matches_jax(indata, jax_images, incremental, backend):
    want = jax_images[incremental]
    cfg = _port_cfg(_jax_cfg(incremental=incremental), backend=backend)
    got = recon.recon_radial2d(indata, cfg, device="cpu")
    assert got.shape == want.shape == (NZ, 1, NRO // 2, NRO // 2)
    assert got.dtype == np.complex64
    assert _frame_nrmse(got, want) <= 1e-5


def test_incremental_matches_direct(indata):
    cfg = _port_cfg(_jax_cfg(), backend="auto")
    direct = recon.recon_radial2d(indata, cfg, device="cpu")
    inc = recon.recon_radial2d(indata, dataclasses.replace(cfg, incremental=True), device="cpu")
    # the gate of bench.py:258-266
    assert _frame_nrmse(inc, direct) < 1e-4


def test_repetitions_coils_and_half_readback(indata):
    cfg = _port_cfg(_jax_cfg(), backend="auto")
    one = recon.recon_radial2d(indata, cfg, device="cpu")
    two = recon.recon_radial2d(np.concatenate([indata, 2 * indata], axis=1), cfg, device="cpu")
    assert two.shape == (NZ, 2, NRO // 2, NRO // 2)
    np.testing.assert_allclose(two[:, 0], one[:, 0], rtol=1e-6, atol=1e-6 * np.abs(one).max())
    np.testing.assert_allclose(two[:, 1], 2 * one[:, 0], rtol=1e-5, atol=1e-5 * np.abs(one).max())
    half = recon.recon_radial2d(indata, cfg, half_readback=True, device="cpu")
    np.testing.assert_array_equal(half.real, one.real.astype(np.float16).astype(np.float32))
    coils = recon.recon_radial2d(indata, dataclasses.replace(cfg, coil_combine="none"),
                                 device="cpu")
    assert coils.shape == (NZ, 1, NC, NRO // 2, NRO // 2)
    sos = np.sqrt((np.abs(coils[:, 0]) ** 2).sum(axis=1))
    np.testing.assert_allclose(sos, one[:, 0].real, rtol=1e-5, atol=1e-6 * sos.max())


# ROADMAP items that later slices ported: their features run, no longer raise
PORTED = {"A11", "A13"}


@pytest.mark.parametrize(
    "change,item",
    [
        (dict(niter=3), "A13"),
        (dict(coil_combine="walsh"), "A16"),
        (dict(coil_compress=1), "A16"),
        (dict(koosh=True), "A15"),
        (dict(adjoint=False), "A11"),
    ],
)
def test_unported_features_raise(indata, change, item):
    """A feature raises NotImplementedError naming its ROADMAP item until it
    is ported; once ported it runs (forward mode on a 32^2 image stack cut
    from the same numbers)."""
    cfg = dataclasses.replace(_port_cfg(_jax_cfg()), **change)
    if item in PORTED:
        inp = indata if cfg.adjoint else np.ascontiguousarray(indata[:, :, :32, :32, None])
        out = recon.recon_radial2d(inp, cfg, device="cpu")
        assert np.isfinite(out).all()
        return
    with pytest.raises(NotImplementedError, match=item):
        recon.recon_radial2d(indata, cfg, device="cpu")


@pytest.mark.parametrize("backend", ["auto", "jnp"])
def test_cgnr_recon_matches_jax(indata, backend):
    """-i 4 through recon_radial2d on 3 frames.  With backend "auto" the
    hoisted sample-plane path must not take the frames: it runs the plain
    adjoint (JAX gates it on niter == 0, tron_tpu/recon.py:90)."""
    d = np.ascontiguousarray(indata[..., : int(NRO * 0.4) + 2 * SLIDE])
    jcfg = _jax_cfg(niter=4)
    want = jrecon(d, jcfg)
    got = recon.recon_radial2d(d, _port_cfg(jcfg, backend=backend), device="cpu")
    assert got.shape == want.shape == (3, 1, NRO // 2, NRO // 2)
    assert _frame_nrmse(got, want) <= 1e-4
    adj = recon.recon_radial2d(d, _port_cfg(_jax_cfg(), backend=backend), device="cpu")
    assert _frame_nrmse(got, adj) > 1e-2  # CGNR, not the plain adjoint


def test_forward_recon_matches_jax():
    """Forward mode: (nc, nt, nx, ny, nz) images -> (nz, nc, nt, npe1, nro),
    -G -u 0.5 -s 7, one angle set for every frame."""
    rng = np.random.default_rng(12)
    shape = (2, 2, 32, 32, 3)
    imgs = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    jcfg = JaxConfig(golden_angle=True, data_undersamp=0.5, skip_angles=7, backend="jnp")
    want = jrecon(imgs, jcfg)
    for backend in ("auto", "jnp"):
        got = recon.recon_radial2d(imgs, _port_cfg(jcfg, backend=backend), device="cpu")
        assert got.shape == want.shape == (3, 2, 2, 32, 64)
        assert got.dtype == np.complex64
        assert nrmse(got, want) <= 1e-5


def test_kernel_backend_on_cpu_tensor_raises(indata):
    cfg = _port_cfg(_jax_cfg(), backend="pallas")
    launches = grid_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        recon.recon_radial2d(indata, cfg, device="cpu")
    assert grid_cuda.LAUNCHES == launches


def _fingerprint(x):
    """tests/test_golden.py:15-20."""
    x = np.asarray(x)
    return np.array(
        [np.abs(x).sum(), np.abs(x).max(), float(np.abs(x.sum())), np.abs(x[..., ::7, ::7]).sum()]
    )


def test_adjoint_fingerprint():
    """JAX's forward data through the port's adjoint meets the golden of
    tests/test_golden.py:40."""
    jcfg = JaxConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    angles = np.asarray(jangles(48, AngleScheme.LINEAR_HALF))
    data = np.asarray(jnufft_forward(jnp.asarray(shepp_logan(32)), jnp.asarray(angles), jcfg))
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))
    rec = nufft.nufft_adjoint(torch.from_numpy(data), torch.from_numpy(angles), cfg)
    want = np.array([157.8703, 0.7631, 156.9158, 3.1219])
    np.testing.assert_allclose(_fingerprint(rec.numpy()), want, rtol=2e-3)


def test_cli_round_trip_matches_tron(tmp_path, indata, monkeypatch):
    fin = tmp_path / "in.ra"
    ra_write(indata[..., None], fin)
    args = ["-a", "-G", "-u", "0.4", "-d", str(SLIDE)]
    assert jcli.main(args + [str(fin), str(tmp_path / "jax.ra")]) == 0
    # -g names a CUDA device; the CPU route is taken here by handing the
    # CLI the CPU in place of the card
    monkeypatch.setattr(cli, "resolve_device", lambda index: torch.device("cpu"))
    assert cli.main(args + ["--incremental", str(fin), str(tmp_path / "port.ra")]) == 0
    want = ra_read(tmp_path / "jax.ra")
    got = ra_read(tmp_path / "port.ra")
    assert got.shape == want.shape == (1, 1, NRO // 2, NRO // 2, NZ)
    assert got.dtype == want.dtype == np.complex64
    assert nrmse(got, want) <= 1e-5
    assert cli.main(args + ["--half", str(fin), str(tmp_path / "half.ra")]) == 0
    half = ra_read(tmp_path / "half.ra")
    assert half.dtype == np.float16 and half.shape == (2,) + want.shape


def test_cli_forward_and_cgnr_match_tron(tmp_path, indata, monkeypatch):
    """tron-torch forward (no -a) and -i 3 (and --toeplitz) vs tron on the
    CPU, through .ra files."""
    monkeypatch.setattr(cli, "resolve_device", lambda index: torch.device("cpu"))
    rng = np.random.default_rng(13)
    shape = (2, 1, 32, 32, 2)
    imgs = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    fimg = tmp_path / "img.ra"
    ra_write(imgs, fimg)
    assert jcli.main(["-G", "-u", "0.5", str(fimg), str(tmp_path / "jfwd.ra")]) == 0
    assert cli.main(["-G", "-u", "0.5", str(fimg), str(tmp_path / "fwd.ra")]) == 0
    want = ra_read(tmp_path / "jfwd.ra")
    got = ra_read(tmp_path / "fwd.ra")
    assert got.shape == want.shape == (2, 1, 64, 32, 2)
    assert nrmse(got, want) <= 1e-5

    fin = tmp_path / "in.ra"
    ra_write(np.ascontiguousarray(indata[..., : int(NRO * 0.4) + SLIDE])[..., None], fin)
    args = ["-a", "-G", "-u", "0.4", "-d", str(SLIDE), "-i", "3"]
    for extra in ([], ["--toeplitz"]):
        assert jcli.main(args + extra + [str(fin), str(tmp_path / "jcg.ra")]) == 0
        assert cli.main(args + extra + [str(fin), str(tmp_path / "cg.ra")]) == 0
        want = ra_read(tmp_path / "jcg.ra")
        got = ra_read(tmp_path / "cg.ra")
        assert got.shape == want.shape == (1, 1, NRO // 2, NRO // 2, 2)
        assert nrmse(got, want) <= 1e-4


# flags that later slices ported: they pass the parser and the run goes on
# to read the (missing) input
PORTED_FLAGS = {"-i", "forward mode", "--stream"}


@pytest.mark.parametrize(
    "argv,flag",
    [
        (["-a", "-i", "3"], "-i"),
        (["-a", "--stream"], "--stream"),
        (["-a", "--shard"], "--shard"),
        (["-3", "-a"], "-3"),
        (["-a", "--combine", "walsh"], "--combine walsh"),
        ([], "forward mode"),
    ],
)
def test_cli_refuses_unported_flags(tmp_path, capsys, argv, flag):
    rc = cli.main(argv + [str(tmp_path / "in.ra")])
    err = capsys.readouterr().err
    if flag in PORTED_FLAGS:
        assert rc == 1 and "error: " in err and "not ported" not in err
        return
    assert rc == 2
    assert f"error: {flag}" in err


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tron_tpu'] = None\n"
        "import tron_tpu_torch, tron_tpu_torch.recon, tron_tpu_torch.cli\n"
        "import tron_tpu_torch.ops.grid_cuda, tron_tpu_torch._build, tron_tpu_torch.device\n"
        "import tron_tpu_torch.ops.degrid_cuda, tron_tpu_torch.solver, tron_tpu_torch.oracle\n"
        "import tron_tpu_torch.phantom, tron_tpu_torch.metrics, tron_tpu_torch.io.native\n"
        "import tron_tpu_torch.ops.cull, tron_tpu_torch.tools.kbench\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tron_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
