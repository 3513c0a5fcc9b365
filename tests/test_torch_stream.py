"""The port's streamed recon (`recon_radial2d_streaming`, `tron-torch
--stream`), its windowed reader (`io/native.py`), `RaWriter` and the kernel
bench tool, vs the JAX package on the CPU.

The cases mirror tests/test_cli_extended.py:102-135, 230-316, 396-484:
several blocks (the realigned tail included), --incremental, --half,
--combine none, nt > 1, an f16-pair input, --compress and -i 2.  Inputs
are .ra files of seeded numpy data, read by both packages; on the CPU the
port's kernel wrappers take their plain versions.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu import cli as jcli
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.io import RaWriter as JRaWriter
from tron_tpu.io import native as jnative
from tron_tpu.recon import _stream_coil_basis as jbasis
from tron_tpu.recon import recon_radial2d_streaming as jstream
from tron_tpu_torch import cli, recon
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.io import RaWriter, ra_query, ra_read, ra_write
from tron_tpu_torch.io import native
from tron_tpu_torch.ops import grid_cuda

torch.set_num_threads(1)

ARGS = ["-a", "-G", "-u", "0.5", "-d", "4"]
F16_ULP = 2.0**-11  # float16 unit roundoff: two f16 roundings of fp32 values 1e-7 apart


def _write(tmp_path, name, shape, seed, low_rank=False):
    rng = np.random.default_rng(seed)
    if low_rank:  # data spanning a 2-D coil subspace with distinct eigenvalues
        nc = shape[0]
        base = rng.standard_normal((2,) + shape[1:]) + 1j * rng.standard_normal((2,) + shape[1:])
        base[1] *= 0.3
        mix = rng.standard_normal((nc, 2)) + 1j * rng.standard_normal((nc, 2))
        d = np.einsum("ck,ktrpz->ctrpz", mix, base)
    else:
        d = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    p = tmp_path / name
    ra_write(d.astype(np.complex64), p)
    return p


@pytest.fixture
def on_cpu(monkeypatch):
    # -g names a CUDA device; the CPU route is taken by handing the CLI the
    # CPU in place of the card
    monkeypatch.setattr(cli, "resolve_device", lambda index: torch.device("cpu"))


def _jax_cfg(**kw):
    return JaxConfig(golden_angle=True, data_undersamp=0.5, prof_slide=4, adjoint=True, **kw)


def _port_cfg(jcfg):
    return ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("incremental", [False, True])
def test_streaming_driver_matches_jax(tmp_path, incremental):
    """batch_frames=7 forces several blocks and a realigned tail (nz 15)."""
    p = _write(tmp_path, "d.ra", (2, 1, 32, 72, 1), 1)
    jcfg = _jax_cfg(incremental=incremental)
    want = jstream(p, jcfg, batch_frames=7)
    got = recon.recon_radial2d_streaming(p, _port_cfg(jcfg), batch_frames=7, device="cpu")
    assert got.shape == want.shape == (15, 1, 16, 16) and got.dtype == np.complex64
    assert nrmse(got, want) <= 1e-5
    mem = recon.recon_radial2d(ra_read(p)[..., 0], _port_cfg(_jax_cfg()), device="cpu")
    if incremental:  # each block restarts the telescoping sum
        assert nrmse(got, mem) <= 1e-5
    else:  # the same frames through the same gridder
        np.testing.assert_array_equal(got, mem)


@pytest.mark.parametrize(
    "extra,shape",
    [([], (2, 1, 32, 200, 1)), (["--incremental"], (2, 1, 32, 200, 1)),
     (["--combine", "none"], (3, 1, 32, 72, 1)), (["-i", "2"], (2, 1, 32, 72, 1)),
     ([], (2, 3, 32, 72, 1)), (["--combine", "walsh"], (3, 1, 32, 72, 1)),
     (["--combine", "walsh", "--incremental"], (3, 1, 32, 72, 1)),
     (["--combine", "walsh", "-i", "2"], (3, 1, 32, 72, 1))],
    ids=["plain", "incremental", "combine-none", "cgnr", "nt3", "walsh", "walsh-incremental",
         "walsh-cgnr"],
)
def test_cli_stream_matches_tron_stream(tmp_path, on_cpu, extra, shape):
    p = _write(tmp_path, "d.ra", shape, 2)
    args = ARGS + extra + [str(p)]
    a, b, c = (str(tmp_path / f"{k}.ra") for k in "abc")
    assert jcli.main(args + [a, "--stream"]) == 0
    assert cli.main(args + [b, "--stream"]) == 0
    assert cli.main(args + [c]) == 0
    ja, got, mem = ra_read(a), ra_read(b), ra_read(c)
    assert got.shape == ja.shape == mem.shape and got.dtype == np.complex64
    assert nrmse(got, ja) <= (1e-4 if "-i" in extra else 1e-5)  # CGNR: test_torch_solver.py
    if "--incremental" in extra:
        assert nrmse(got, mem) <= 1e-5
    else:
        np.testing.assert_array_equal(got, mem)


def test_cli_stream_half(tmp_path, on_cpu):
    """--stream --half: the f16 planes written by region equal the
    in-memory --half file bit for bit, and JAX's within f16 rounding."""
    p = _write(tmp_path, "d.ra", (2, 1, 32, 120, 1), 3)
    args = ARGS + ["--half", str(p)]
    a, b, c = (str(tmp_path / f"{k}.ra") for k in "abc")
    assert jcli.main(args + [a, "--stream"]) == 0
    assert cli.main(args + [b, "--stream"]) == 0
    assert cli.main(args + [c]) == 0
    got = ra_read(b)
    assert ra_query(b).dims == ra_query(a).dims and got.dtype == np.float16 and got.shape[0] == 2
    np.testing.assert_array_equal(got, ra_read(c))
    assert nrmse(got.astype(np.float32), ra_read(a).astype(np.float32)) <= F16_ULP


def test_cli_stream_f16_pair_input(tmp_path, on_cpu):
    rng = np.random.default_rng(4)
    d = rng.standard_normal((2, 1, 32, 72, 1)) + 1j * rng.standard_normal((2, 1, 32, 72, 1))
    p = tmp_path / "d16.ra"
    ra_write(np.stack([d.real, d.imag]).astype(np.float16), p)
    a, b, c = (str(tmp_path / f"{k}.ra") for k in "abc")
    assert jcli.main(ARGS + [str(p), a, "--stream"]) == 0
    assert cli.main(ARGS + [str(p), b, "--stream"]) == 0
    assert cli.main(ARGS + [str(p), c]) == 0
    assert ra_query(b).dims == ra_query(a).dims == (1, 1, 16, 16, 15)
    assert nrmse(ra_read(b), ra_read(a)) <= 1e-5
    np.testing.assert_array_equal(ra_read(b), ra_read(c))


@pytest.mark.parametrize("combine", ["sos", "none"])
def test_cli_stream_compress_matches_tron_stream(tmp_path, on_cpu, combine):
    """--stream --compress 2: the same disk Gram pass and host projection
    as `tron --stream --compress`, so the same virtual coils."""
    p = _write(tmp_path, "d.ra", (6, 1, 32, 120, 1), 5, low_rank=True)
    args = ARGS + ["--compress", "2", "--combine", combine, str(p)]
    a, b = str(tmp_path / "a.ra"), str(tmp_path / "b.ra")
    assert jcli.main(args + [a, "--stream"]) == 0
    assert cli.main(args + [b, "--stream"]) == 0
    assert ra_query(b).dims == ra_query(a).dims
    assert ra_query(b).dims[0] == (2 if combine == "none" else 1)
    assert nrmse(ra_read(b), ra_read(a)) <= 1e-5


@pytest.mark.parametrize("combine", ["sos", "none"])
def test_cli_compress_in_memory_matches_tron_and_stream(tmp_path, on_cpu, combine):
    """--compress 2 without --stream (torch.linalg.eigh of the coil Gram
    matrix on the device) vs `tron --compress 2`, and vs the streamed
    compression, whose basis comes from a disk pass: the same subspace, each
    virtual coil up to a phase, so root-sum-of-squares images agree."""
    p = _write(tmp_path, "d.ra", (6, 2, 32, 120, 1), 5, low_rank=True)
    args = ARGS + ["--compress", "2", "--combine", combine, str(p)]
    a, b, c = (str(tmp_path / f"{k}.ra") for k in "abc")
    assert jcli.main(args + [a]) == 0
    assert cli.main(args + [b]) == 0
    assert cli.main(args + [c, "--stream"]) == 0
    assert ra_query(b).dims == ra_query(a).dims == ra_query(c).dims
    assert ra_query(b).dims[0] == (2 if combine == "none" else 1)
    sos = lambda x: np.sqrt((np.abs(x) ** 2).sum(axis=0))  # noqa: E731
    assert nrmse(sos(ra_read(b)), sos(ra_read(a))) <= 1e-5
    assert nrmse(sos(ra_read(b)), sos(ra_read(c))) <= 1e-4


def test_stream_coil_basis_chunked_matches_jax(tmp_path):
    """The chunked disk Gram equals the one-shot one and JAX's (compared as
    projectors: eigenvectors are phase-ambiguous)."""
    p = _write(tmp_path, "d.ra", (3, 2, 16, 50, 1), 6)
    b1 = recon._stream_coil_basis(p, 50, 2, chunk=7)
    b2 = recon._stream_coil_basis(p, 50, 2, chunk=50)
    bj = jbasis(p, 50, 2, chunk=7)
    assert b1.shape == bj.shape == (2, 3, 2) and b1.dtype == np.complex64
    for t in range(2):
        P1, P2, PJ = (b[t] @ b[t].conj().T for b in (b1, b2, bj))
        np.testing.assert_allclose(P1, P2, atol=1e-5)
        np.testing.assert_allclose(P1, PJ, atol=1e-5)


@pytest.mark.parametrize("kind", ["complex", "float", "pair"])
def test_read_profiles_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(7)
    d = rng.standard_normal((3, 2, 8, 20, 1)) + 1j * rng.standard_normal((3, 2, 8, 20, 1))
    if kind == "complex":
        arr = d.astype(np.complex64)
    elif kind == "float":
        arr = d.real.astype(np.float32)
    else:
        arr = np.stack([d.real, d.imag]).astype(np.float16)
    p = tmp_path / "d.ra"
    ra_write(arr, p)
    hdr = ra_query(p)
    assert native.radial_dims(hdr) == jnative.radial_dims(hdr)
    got = native.ra_read_profiles(p, 5, 9)
    want = jnative.ra_read_profiles(p, 5, 9)
    assert got.shape == (3, 2, 8, 9) and got.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        native.ra_read_profiles(p, 15, 9)


def test_ra_writer_matches_jax(tmp_path):
    """Header first, regions in any order, close replaces atomically; the
    bytes equal JAX's RaWriter's; abort removes the partial file."""
    rng = np.random.default_rng(8)
    frames = (rng.standard_normal((4, 6)) + 1j * rng.standard_normal((4, 6))).astype(np.complex64)
    dims = (2, 3, 4)
    for cls, name in ((RaWriter, "port.ra"), (JRaWriter, "jax.ra")):
        w = cls(tmp_path / name, dims, np.complex64)
        w.write_at(12, frames[2:])
        w.write_at(0, frames[:2])
        w.close()
    assert (tmp_path / "port.ra").read_bytes() == (tmp_path / "jax.ra").read_bytes()
    np.testing.assert_array_equal(ra_read(tmp_path / "port.ra"), frames.reshape(4, 3, 2).T)
    w = RaWriter(tmp_path / "gone.ra", dims, np.float16)
    with pytest.raises(ValueError, match="exceeds"):
        w.write_at(20, np.zeros(8, np.float16))
    w.abort()
    assert not any(f.name.startswith("gone.ra") for f in tmp_path.iterdir())
    native.ra_write_region(tmp_path / "port.ra", 8, np.full(1, 7 + 1j, np.complex64))
    assert ra_read(tmp_path / "port.ra")[1, 0, 0] == 7 + 1j


def test_stream_refusals(tmp_path, on_cpu, capsys):
    """Unported stream modes exit 2 naming the flag; input errors exit 1
    and leave no partial output; forward --stream notes it loads in
    memory.  The modes ported since (-3 --stream, --compress
    without --stream, --stream --combine walsh) run."""
    p = _write(tmp_path, "d.ra", (2, 1, 32, 40, 1), 9)
    out = str(tmp_path / "o.ra")
    for argv, msg in (
        (["-a", "--stream", "--shard"], "error: --shard"),
        (["-a", "--stream", "--shard-spokes"], "error: --shard-spokes"),
    ):
        assert cli.main(argv + [str(p), out]) == 2
        assert msg in capsys.readouterr().err
        assert not os.path.exists(out)
    for argv in (["-3", "-a", "--stream"], ["-a", "--compress", "1"],
                 ["-a", "--stream", "--combine", "walsh"]):
        assert cli.main(argv + [str(p), out]) == 0
        assert capsys.readouterr().err == "" and np.isfinite(ra_read(out)).all()
        os.remove(out)
    assert cli.main(["-a", "--stream", str(tmp_path / "missing.ra"), out]) == 1
    capsys.readouterr()
    ra_write(np.zeros((2, 1, 32, 40), np.complex64), tmp_path / "d4.ra")
    assert cli.main(["-a", "--stream", str(tmp_path / "d4.ra"), out]) == 1
    assert "expected 5-D .ra input, got 4-D" in capsys.readouterr().err
    assert not os.path.exists(out)
    img = tmp_path / "img.ra"
    ra_write(np.zeros((1, 1, 8, 8, 1), np.complex64), img)
    assert cli.main(["--stream", str(img), out]) == 0
    assert "--stream ignored" in capsys.readouterr().out


def test_streaming_driver_guards(tmp_path):
    p = _write(tmp_path, "d.ra", (2, 1, 32, 40, 1), 10)
    cfg = _port_cfg(_jax_cfg())
    with pytest.raises(NotImplementedError, match="A17"):
        recon.recon_radial2d_streaming(p, cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="adjoint"):
        recon.recon_radial2d_streaming(p, dataclasses.replace(cfg, adjoint=False), device="cpu")
    if not torch.cuda.is_available():  # the default device is the card, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            recon.recon_radial2d_streaming(p, cfg)
    launches = grid_cuda.LAUNCHES
    half = recon.recon_radial2d_streaming(p, cfg, half=True, device="cpu")
    full = recon.recon_radial2d_streaming(p, cfg, device="cpu")
    assert grid_cuda.LAUNCHES == launches
    assert half.shape == (2,) + full.shape and half.dtype == np.float16
    np.testing.assert_array_equal(half[0], full.real.astype(np.float16))


def test_kbench_plain_route_on_cpu():
    """The bench's inputs and ops at a tiny size on the CPU (its timing
    needs the card): the culled and the batched routes agree with the
    plain gridder, the degrid route with the plain degridder."""
    from tron_tpu_torch.tools import kbench

    base = ["--frames", "2", "--nc", "2", "--nro", "64", "--npe", "12"]
    for extra in (["--no-windowed"], ["--batched"], ["--op", "degrid"]):
        args = kbench.build_parser().parse_args(base + extra)
        fn, plain, tuning = kbench.make_case(args, torch.device("cpu"))
        assert tuning.batched == ("--batched" in extra)
        assert kbench.nrmse(fn(1), plain(1)) <= 1e-5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kbench.main(base)
