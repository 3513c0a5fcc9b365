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
from tron_tpu_torch.io import ra_query, ra_read, ra_write
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
PORTED = {"A11", "A13", "A15", "A16"}


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
    from the same numbers; -3 on the same spokes as a stack of one slice)."""
    cfg = dataclasses.replace(_port_cfg(_jax_cfg()), **change)
    if item in PORTED:
        inp = indata if cfg.adjoint else np.ascontiguousarray(indata[:, :, :32, :32, None])
        out = recon.recon_radial2d(inp[..., None] if cfg.koosh else inp, cfg, device="cpu")
        assert np.isfinite(out).all()
        plain = recon.recon_radial2d(indata, _port_cfg(_jax_cfg()), device="cpu")
        if item == "A15":  # one slice, frames that do not overlap
            assert out.shape == (3, 1, NRO // 2, NRO // 2) and nrmse(out[0], plain[0]) <= 1e-6
        elif item == "A16":
            assert out.shape == plain.shape and nrmse(out, plain) > 1e-3
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
PORTED_FLAGS = {"-i", "forward mode", "--stream", "-3", "--combine walsh", "--compress", "-B",
                "-T", "-r", "--scheme", "--backend", "--precision", "--profile", "--shard",
                "--shard-spokes"}


@pytest.mark.parametrize(
    "argv,flag",
    [
        (["-a", "-i", "3"], "-i"),
        (["-a", "--stream"], "--stream"),
        (["-a", "--shard"], "--shard"),
        (["-a", "--shard-spokes"], "--shard-spokes"),
        (["-a", "-k", "7"], "-k 7"),
        (["-k", "7.5", "-i", "2"], "-k 7.5"),
        (["-3", "-a"], "-3"),
        (["-3", "-a", "--stream"], "-3"),
        (["-a", "--combine", "walsh"], "--combine walsh"),
        (["-a", "--compress", "2"], "--compress"),
        (["-a", "-B", "4096"], "-B"),
        (["-a", "-T", "128"], "-T"),
        (["-a", "-r", "512"], "-r"),
        (["-a", "--scheme", "linear_half"], "--scheme"),
        (["-a", "--backend", "pallas"], "--backend"),
        (["-a", "--precision", "accurate"], "--precision"),
        (["-a", "--profile", "prof"], "--profile"),
        ([], "forward mode"),
    ],
)
def test_cli_refuses_unported_flags(tmp_path, capsys, argv, flag):
    """What is still refused exits 2 with one line naming the flag and the
    reason, before the input is read; every other flag of `tron` is taken."""
    rc = cli.main(argv + [str(tmp_path / "in.ra")])
    err = capsys.readouterr().err
    if flag in PORTED_FLAGS:
        assert rc == 1 and "error: " in err and "not ported" not in err
        return
    assert rc == 2
    assert err.startswith(f"error: {flag}") and len(err.strip().splitlines()) == 1


@pytest.mark.parametrize(
    "extra,jax_extra",
    [
        (["-G", "-B", "4096", "-T", "128", "-r", "128"], None),
        (["--scheme", "linear_half"], None),
        (["--scheme", "linear_full"], None),
        (["-G", "--combine", "walsh"], None),
        (["-G", "--compress", "1"], None),
        (["-G", "--compress", "1", "--combine", "none"], None),
        (["-G", "--backend", "jnp"], None),
        (["-G", "--precision", "accurate"], None),
        (["-G", "-k", "4"], None),
        (["-G", "--profile", "PROF"], ["-G"]),
        (["-G", "--dft-dot", "highest"], None),
        (["-G", "--dft-dot", "bf16x3", "-v"], None),
    ],
    ids=["B-T-r", "linear_half", "linear_full", "walsh", "compress", "compress-none", "backend",
         "precision", "k4", "profile", "dft-dot-highest", "dft-dot-bf16x3"],
)
def test_cli_new_flags_match_tron(tmp_path, indata, monkeypatch, extra, jax_extra):
    """Every flag this CLI newly takes, through `tron` and `tron-torch` on
    the same .ra: the same images.  --profile also leaves a Chrome trace
    (tron's own profile is a jax.profiler trace, so tron runs without it).

    linear_full puts spoke 0 at exactly 90 degrees, its samples on grid
    columns, where the last bit of a coordinate decides whether a window's
    edge neighbour is taken: there JAX's compiled frame loop sits 5e-5 from
    its own eager run, so that case holds the port to JAX run eagerly."""
    import contextlib

    import jax

    monkeypatch.setattr(cli, "resolve_device", lambda index: torch.device("cpu"))
    fin = tmp_path / "in.ra"
    ra_write(np.ascontiguousarray(indata[..., : int(NRO * 0.4) + SLIDE])[..., None], fin)
    prof = str(tmp_path / "prof")
    extra = [prof if x == "PROF" else x for x in extra]
    base = ["-a", "-u", "0.4", "-d", str(SLIDE)]
    eager = jax.disable_jit() if "linear_full" in extra else contextlib.nullcontext()
    with eager:
        assert jcli.main(base + (extra if jax_extra is None else jax_extra)
                         + [str(fin), str(tmp_path / "jax.ra")]) == 0
    assert cli.main(base + extra + [str(fin), str(tmp_path / "port.ra")]) == 0
    want, got = ra_read(tmp_path / "jax.ra"), ra_read(tmp_path / "port.ra")
    assert got.shape == want.shape and got.dtype == want.dtype == np.complex64
    if "--compress" in extra and "none" in extra:
        # a virtual coil is fixed up to a phase: compare magnitudes
        assert nrmse(np.abs(got), np.abs(want)) <= 1e-5
    else:
        assert nrmse(got, want) <= 1e-5
    if "--profile" in extra:
        traces = [f for f in os.listdir(prof) if f.endswith(".trace.json")]
        assert len(traces) == 1 and os.path.getsize(os.path.join(prof, traces[0])) > 0
    if "--dft-dot" in extra:  # ignored: the same file as without the flag
        assert cli.main(base + ["-G", str(fin), str(tmp_path / "plain.ra")]) == 0
        np.testing.assert_array_equal(got, ra_read(tmp_path / "plain.ra"))


def test_cli_linear_angle_roundtrip_matches_tron(tmp_path, monkeypatch):
    """The verify recipe's roundtrip: phantom -> forward -> adjoint with
    --scheme linear_half, through both CLIs; the recon correlates with the
    phantom (without --scheme the two directions' conventions differ)."""
    from tron_tpu_torch.phantom import shepp_logan as port_phantom
    from tron_tpu_torch.tools import make_phantom

    monkeypatch.setattr(cli, "resolve_device", lambda index: torch.device("cpu"))
    n = 64
    sl = tmp_path / "sl.ra"
    make_phantom.main([str(sl), "--n", str(n)])
    imgs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        data, img = tmp_path / f"{name}_data.ra", tmp_path / f"{name}_img.ra"
        assert main([str(sl), str(data)]) == 0
        assert main(["-a", "--scheme", "linear_half", str(data), str(img)]) == 0
        assert ra_query(data).dims == (1, 1, 2 * n, 2 * n, 1)
        imgs[name] = ra_read(img)
    assert imgs["port"].shape == imgs["jax"].shape == (1, 1, n, n, 1)
    assert nrmse(imgs["port"], imgs["jax"]) <= 1e-5
    rec = np.abs(imgs["port"][0, 0, :, :, 0])
    corr = np.corrcoef(rec.ravel(), np.abs(port_phantom(n)).T.ravel())[0, 1]
    assert corr > 0.9


def test_cli_kernel_backend_on_the_cpu_raises(tmp_path, indata, monkeypatch):
    """--backend pallas is the CUDA kernel: on a CPU tensor it raises, it
    never gives way to the plain version."""
    monkeypatch.setattr(cli, "resolve_device", lambda index: torch.device("cpu"))
    fin = tmp_path / "in.ra"
    ra_write(np.ascontiguousarray(indata[..., :60])[..., None], fin)
    with pytest.raises(ValueError, match="CUDA"):
        cli.main(["-a", "-G", "--backend", "pallas", str(fin), str(tmp_path / "o.ra")])
    assert not (tmp_path / "o.ra").exists()


def test_from_jax_fields_carries_the_new_state():
    jcfg = JaxConfig(koosh=True, coil_combine="walsh", walsh_npatch=2, coil_compress=3,
                     angle_scheme=AngleScheme.LINEAR_HALF, backend="jnp", matmul_dtype="bf16x3",
                     dft_dot="bf16x3")
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))
    for field in ("koosh", "coil_combine", "walsh_npatch", "coil_compress", "angle_scheme",
                  "backend", "matmul_dtype"):
        assert getattr(cfg, field) == getattr(jcfg, field)
    assert not hasattr(cfg, "dft_dot")


def test_port_sources_never_import_jax():
    """No module of the port, and not chip_smoke.py, imports jax or tron_tpu."""
    import re

    bad = re.compile(r"^\s*(?:import|from)\s+(?:jax|tron_tpu)(?:[\s.]|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tron_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            assert not bad.search(f.read()), path


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tron_tpu'] = None\n"
        "import tron_tpu_torch, tron_tpu_torch.recon, tron_tpu_torch.cli\n"
        "import tron_tpu_torch.ops.grid_cuda, tron_tpu_torch._build, tron_tpu_torch.device\n"
        "import tron_tpu_torch.ops.degrid_cuda, tron_tpu_torch.solver, tron_tpu_torch.oracle\n"
        "import tron_tpu_torch.phantom, tron_tpu_torch.metrics, tron_tpu_torch.io.native\n"
        "import tron_tpu_torch.ops.cull, tron_tpu_torch.tools.kbench, tron_tpu_torch.viz\n"
        "import tron_tpu_torch.ops.coil, tron_tpu_torch.tools.make_phantom\n"
        "import tron_tpu_torch.tools.make_goldenangle, tron_tpu_torch.tools.ra_tool\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tron_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
