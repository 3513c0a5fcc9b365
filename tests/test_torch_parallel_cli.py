"""The port's CLI and streamed recon on several devices (`tron-torch --shard`,
`--shard-spokes`, `--stream --shard`; `recon_radial2d_streaming(mesh=...)`)
vs `tron` on the CPU.

`tron` shards over the 8 virtual CPU devices of tests/conftest.py.  The port
runs at a world of one rank in this process (the CLI is handed the CPU in
place of the card) and, through tron_tpu_torch.parallel.launch, as the two
gloo ranks of a world of 2.  Inputs are .ra files of seeded numpy data, read
by both packages.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu import cli as jcli
from tron_tpu import parallel as jpar
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.recon import recon_radial2d_streaming as jstream
from tron_tpu_torch import cli, recon
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.io import ra_read, ra_write
from tron_tpu_torch.parallel import launch, make_mesh

torch.set_num_threads(1)

RANKS_TIMEOUT = 240.0  # s for one start of ranks


def _cplx(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


ARGS = ["-a", "-G", "-u", "0.5", "-d", "4"]


@pytest.fixture
def on_cpu(monkeypatch):
    # -g names a CUDA device; the CPU route is taken by handing the CLI the
    # CPU in place of the card (a world of one rank, in this process)
    monkeypatch.setattr(cli, "resolve_device", lambda index=0: torch.device("cpu"))


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    p = tmp_path_factory.mktemp("series") / "d.ra"
    ra_write(_cplx(21, (4, 2, 32, 72, 1)), p)
    return str(p)


@pytest.mark.parametrize(
    "extra",
    [["--shard"], ["--shard", "--incremental"], ["--shard", "--combine", "none"],
     ["--shard", "--combine", "walsh"], ["--shard", "-i", "2"], ["--stream", "--shard"],
     ["--stream", "--shard", "--half"], ["--shard-spokes"], ["--shard-spokes", "-i", "2"],
     ["--shard-spokes", "--combine", "none"]],
    ids=lambda e: "".join(e).replace("--", "-").lstrip("-"),
)
def test_cli_shard_flags_match_tron(tmp_path, on_cpu, series, extra):
    """tron-torch --shard / --shard-spokes at a world of 1 vs `tron` with the
    same flags on its 8 CPU devices, and vs tron-torch without them."""
    a, b, c = (str(tmp_path / f"{k}.ra") for k in "abc")
    assert jcli.main(ARGS + extra + [series, a]) == 0
    assert cli.main(ARGS + extra + [series, b]) == 0
    plain = [x for x in extra if x not in ("--shard", "--shard-spokes")]
    assert cli.main(ARGS + plain + [series, c]) == 0
    want, got, mem = ra_read(a), ra_read(b), ra_read(c)
    assert got.shape == want.shape == mem.shape and got.dtype == want.dtype
    tol = 2.0**-11 if "--half" in extra else 1e-4 if "-i" in extra else 1e-5
    assert nrmse(got.astype(np.complex64), want.astype(np.complex64)) <= tol
    np.testing.assert_array_equal(got, mem)  # one rank: the unsharded calls on the same numbers


@pytest.mark.parametrize(
    "argv,note",
    [(["--shard-spokes", "--incremental"], "--incremental ignored (spoke-sharded recon"),
     (["--shard-spokes", "--stream"], "--stream ignored (--shard-spokes loads"),
     (["--shard", "--compress", "2"], "--compress ignored (the in-memory sharded"),
     (["--shard", "--incremental"], None)],
)
def test_cli_shard_notes(tmp_path, on_cpu, series, capsys, argv, note):
    """The notes of tron_tpu/cli.py:309-338, and the port's own for
    --compress, which `tron --shard` drops without a word."""
    out = str(tmp_path / "o.ra")
    assert cli.main(ARGS + argv + [series, out]) == 0
    said = capsys.readouterr().out
    if note is None:
        assert "note:" not in said
    else:
        assert f"note: {note}" in said
    assert np.isfinite(ra_read(out)).all()


def test_cli_shard_koosh_and_forward_match_tron(tmp_path, on_cpu, capsys):
    """-3 --shard (and the note of -3 --stream --shard) and forward --shard,
    2-D and -3, vs `tron`."""
    k = tmp_path / "k.ra"
    ra_write(_cplx(22, (2, 1, 32, 16, 5)), k)
    a, b = str(tmp_path / "a.ra"), str(tmp_path / "b.ra")
    for extra in (["--shard"], ["--stream", "--shard"]):
        argv = ["-3", "-a", "-G", "-u", "0.5"] + extra + [str(k)]
        assert jcli.main(argv + [a]) == 0
        capsys.readouterr()
        assert cli.main(argv + [b]) == 0
        assert ("note: --stream ignored (-3 --shard" in capsys.readouterr().out) == ("--stream" in extra)
        assert ra_read(b).shape == ra_read(a).shape == (1, 1, 16, 16, 5)
        assert nrmse(ra_read(b), ra_read(a)) <= 1e-5
    im = tmp_path / "im.ra"
    ra_write(_cplx(23, (2, 1, 16, 16, 3)), im)
    for flags in ([], ["-3"]):
        argv = flags + ["-G", "-u", "0.5", "--shard", str(im)]
        assert jcli.main(argv + [a]) == 0 and cli.main(argv + [b]) == 0
        assert ra_read(b).shape == ra_read(a).shape == (2, 1, 32, 16, 3)
        assert nrmse(ra_read(b), ra_read(a)) <= 1e-5


@pytest.mark.parametrize(
    "extra", [["--shard"], ["--stream", "--shard", "--incremental"], ["--shard-spokes"]],
    ids=["shard", "stream-shard-incremental", "shard-spokes"],
)
def test_cli_in_two_ranks_rank0_writes(tmp_path, series, extra):
    """The CLI as the ranks of a world of 2 (what main() starts per card, or
    torchrun): every rank reads the input, rank 0 alone writes, and the file
    is `tron`'s."""
    a, b = str(tmp_path / "a.ra"), str(tmp_path / "b.ra")
    assert jcli.main(ARGS + extra + [series, a]) == 0
    res = launch.start_ranks("tron_tpu_torch.cli:rank_main", 2, {"argv": ARGS + extra + [series, b]},
                             device="cpu", timeout=RANKS_TIMEOUT)
    assert [r.value for r in res] == [0, 0]
    assert sorted(os.listdir(tmp_path)) == ["a.ra", "b.ra"]
    want, got = ra_read(a), ra_read(b)
    assert got.shape == want.shape and nrmse(got, want) <= 1e-5


def test_streamed_mesh_matches_jax_streamed_mesh(tmp_path, series):
    """recon_radial2d_streaming(mesh=...): several blocks with a realigned
    tail through the sharded scheduler, JAX on a 2 x 1 mesh of its CPU
    devices, the port at a world of 1 here and of 2 through the CLI test
    above; one rank changes no bit of the unsharded stream."""
    jcfg = JaxConfig(golden_angle=True, data_undersamp=0.5, prof_slide=4, adjoint=True)
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))
    jmesh = jpar.make_mesh(n_frame=2, n_coil=1, devices=jax.devices()[:2])
    want = jstream(series, jcfg, batch_frames=6, mesh=jmesh)
    mesh = make_mesh(device="cpu")
    got = recon.recon_radial2d_streaming(series, cfg, batch_frames=6, mesh=mesh)
    assert got.shape == want.shape == (15, 2, 16, 16)
    assert nrmse(got, want) <= 1e-5
    np.testing.assert_array_equal(
        got, recon.recon_radial2d_streaming(series, cfg, batch_frames=6, device="cpu"))
