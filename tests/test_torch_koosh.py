"""The port's 3-D stack-of-stars recon (`-3`: tron_tpu_torch.recon's koosh
functions, in memory and streamed, `io.native.ra_read_profiles_stack`, and
`tron-torch -3`) vs the JAX package on the CPU.

Small sizes (n 32, 2 coils, 4 or 8 kz encodings); inputs are numpy arrays
from seeds, configs cross packages through ReconConfig.from_jax_fields.  On
the CPU the port's kernel wrappers take their plain versions; JAX runs its
`jnp` backend.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu import cli as jcli
from tron_tpu.config import ReconConfig as JaxConfig
from tron_tpu.io import native as jnative
from tron_tpu.recon import recon_koosh_streaming as jkoosh_stream
from tron_tpu.recon import recon_radial2d as jrecon
from tron_tpu_torch import cli, recon
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.io import native, ra_query, ra_read, ra_write
from tron_tpu_torch.ops import degrid_cuda, grid_cuda

torch.set_num_threads(1)

N, NC = 32, 2
NRO = 2 * N
F16_ULP = 2.0**-11


def _complex(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _scheme_kw(scheme):
    if scheme == "golden":
        return dict(golden_angle=True, data_undersamp=0.25)  # 16 spokes per in-plane frame
    return dict(angle_scheme="linear_half", data_undersamp=0.25)


def _port_cfg(jcfg, **kw):
    return dataclasses.replace(ReconConfig.from_jax_fields(dataclasses.asdict(jcfg)), **kw)


@pytest.fixture
def on_cpu(monkeypatch):
    # -g names a CUDA device; the CPU route is taken by handing the CLI the
    # CPU in place of the card
    monkeypatch.setattr(cli, "resolve_device", lambda index: torch.device("cpu"))


@pytest.mark.parametrize("scheme", ["golden", "linear_half"])
@pytest.mark.parametrize("nt", [1, 2])
@pytest.mark.parametrize("npe2", [4, 8])
def test_koosh_adjoint_matches_jax(npe2, nt, scheme):
    """(nc, nt, nro, npe1, npe2) -> (npe2*nzi, nt, n, n), slice-major; 40
    spokes give 2 in-plane frames of 16."""
    d = _complex(npe2 + nt, (NC, nt, NRO, 40, npe2))
    jcfg = JaxConfig(koosh=True, adjoint=True, backend="jnp", skip_angles=3, **_scheme_kw(scheme))
    want = jrecon(d, jcfg)
    launches = grid_cuda.LAUNCHES
    got = recon.recon_radial2d(d, _port_cfg(jcfg, backend="auto"), device="cpu")
    assert grid_cuda.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert got.shape == want.shape == (npe2 * 2, nt, N, N) and got.dtype == np.complex64
    assert nrmse(got, want) <= 1e-5
    # the layout of the input does not matter: a .ra payload is Fortran-ordered
    np.testing.assert_array_equal(
        recon.recon_radial2d(np.asfortranarray(d), _port_cfg(jcfg), device="cpu"), got)


@pytest.mark.parametrize("scheme", ["golden", "linear_half"])
@pytest.mark.parametrize("nt", [1, 2])
@pytest.mark.parametrize("npe2", [4, 8])
def test_koosh_forward_matches_jax(npe2, nt, scheme):
    """(nc, nt, nx, ny, nz) -> (npe2, nc, nt, npe1, nro): every coil and
    repetition a channel of one degridding call per slice, then the kz FFT."""
    imgs = _complex(10 + npe2 + nt, (NC, nt, N, N, npe2))
    jcfg = JaxConfig(koosh=True, backend="jnp", skip_angles=2, **_scheme_kw(scheme))
    want = jrecon(imgs, jcfg)
    launches = degrid_cuda.LAUNCHES
    got = recon.recon_radial2d(imgs, _port_cfg(jcfg, backend="auto"), device="cpu")
    assert degrid_cuda.LAUNCHES == launches
    assert got.shape == want.shape == (npe2, NC, nt, 16, NRO) and got.dtype == np.complex64
    assert nrmse(got, want) <= 1e-5


def test_koosh_kz_axis_decouples():
    """The kz transform is centred and unnormalised, and slice b of the
    output is the 2-D recon of slice b of the host-side kz inverse FFT."""
    d = _complex(3, (NC, 1, NRO, 40, 4))
    cfg = ReconConfig(koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.25,
                      skip_angles=5)
    got = recon.recon_radial2d(d, cfg, device="cpu")
    sl = np.fft.fftshift(np.fft.ifft(np.fft.ifftshift(d, axes=-1), axis=-1), axes=-1) * 4
    cfg2 = dataclasses.replace(cfg, koosh=False)
    for b in range(4):
        want = recon.recon_radial2d(sl[..., b].astype(np.complex64), cfg2, device="cpu")
        assert nrmse(got[2 * b : 2 * b + 2], want) <= 1e-5


@pytest.mark.parametrize("combine", ["none", "walsh"])
def test_koosh_combine_modes_match_jax(combine):
    d = _complex(4, (3, 1, NRO, 16, 4))
    jcfg = JaxConfig(koosh=True, adjoint=True, backend="jnp", golden_angle=True,
                     coil_combine=combine)
    want = jrecon(d, jcfg)
    got = recon.recon_radial2d(d, _port_cfg(jcfg), device="cpu")
    assert got.shape == want.shape == ((4, 1, 3, N, N) if combine == "none" else (4, 1, N, N))
    assert nrmse(got, want) <= 1e-5


def test_koosh_half_readback_and_block_tail():
    """float16 readback equals the float16 rounding of the complex64 output;
    kz blocks smaller than npe2 with a realigned tail (5 slices in blocks
    of 2: starts 0, 2, 3) give the same frames."""
    d = _complex(5, (NC, 2, NRO, 40, 5))
    cfg = ReconConfig(koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.25)
    full = recon.recon_radial2d(d, cfg, device="cpu")
    half = recon.recon_radial2d(d, cfg, half_readback=True, device="cpu")
    np.testing.assert_array_equal(half.real, full.real.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(half.imag, full.imag.astype(np.float16).astype(np.float32))
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    blocked = recon._koosh_adjoint_pipelined(torch.from_numpy(d), cfg2, 16, 16, 2, kz_block=2)
    np.testing.assert_array_equal(blocked, full)
    assert recon._block_starts(5, 2) == [0, 2, 3] and recon._block_starts(4, 8 - 4) == [0]
    with pytest.raises(ValueError, match="npe2"):
        recon.recon_radial2d(d[..., 0], cfg, device="cpu")


@pytest.mark.parametrize("kind", ["complex", "float", "pair"])
def test_read_profiles_stack_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(7)
    shape = (3, 2, 8, 20, 4)
    d = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if kind == "complex":
        arr = d.astype(np.complex64)
    elif kind == "float":
        arr = d.real.astype(np.float32)
    else:
        arr = np.stack([d.real, d.imag]).astype(np.float16)
    p = tmp_path / "d.ra"
    ra_write(arr, p)
    got = native.ra_read_profiles_stack(p, 5, 9)
    want = jnative.ra_read_profiles_stack(p, 5, 9)
    assert got.shape == (3, 2, 8, 9, 4) and got.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        native.ra_read_profiles_stack(p, 15, 9)


@pytest.mark.parametrize("nt,npe2,kz_block", [(1, 3, 8), (2, 5, 2)])
def test_koosh_streaming_matches_in_memory_and_jax(tmp_path, nt, npe2, kz_block):
    """-3 --stream: 120 spokes are 7 in-plane frames of 16, streamed
    in windows of 3 (starts 0, 3, 4: a realigned tail on the frame axis),
    and with kz_block 2 of 5 slices a realigned tail on the kz axis too.
    The same frames through the same gridder as in memory: the same bits."""
    d = _complex(6 + nt, (NC, nt, 32, 120, npe2))
    p = tmp_path / "d.ra"
    ra_write(d, p)
    jcfg = JaxConfig(koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.5,
                     backend="jnp")
    cfg = _port_cfg(jcfg)
    mem = recon.recon_radial2d(d, cfg, device="cpu")
    got = recon.recon_koosh_streaming(p, cfg, batch_frames=3, device="cpu", kz_block=kz_block)
    assert got.shape == mem.shape == (npe2 * 7, nt, 16, 16) and got.dtype == np.complex64
    np.testing.assert_array_equal(got, mem)
    assert nrmse(got, jkoosh_stream(p, jcfg, batch_frames=3)) <= 1e-5
    # through a writer: contiguous runs of one slice's frames, complex64 also
    # when the readback is float16
    seen = np.zeros(mem.shape, np.complex64)

    def writer(z0, blk):
        assert blk.dtype == np.complex64 and blk.shape == (3, nt, 16, 16)
        seen[z0 : z0 + 3] = blk

    assert recon.recon_koosh_streaming(p, cfg, batch_frames=3, writer=writer, half=True,
                                       device="cpu", kz_block=kz_block) is None
    np.testing.assert_array_equal(seen.real, mem.real.astype(np.float16).astype(np.float32))


def test_koosh_streaming_guards(tmp_path):
    p = tmp_path / "d.ra"
    ra_write(_complex(8, (NC, 1, 32, 16, 2)), p)
    cfg = ReconConfig(koosh=True, adjoint=True, golden_angle=True)
    with pytest.raises(ValueError, match="-3 adjoint"):
        recon.recon_koosh_streaming(p, dataclasses.replace(cfg, koosh=False), device="cpu")
    with pytest.raises(ValueError, match="use -3"):
        recon.recon_radial2d_streaming(p, dataclasses.replace(cfg, koosh=False), device="cpu")
    if not torch.cuda.is_available():  # the default device is the card, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            recon.recon_koosh_streaming(p, cfg)


@pytest.mark.parametrize(
    "extra",
    [[], ["--stream"], ["--half"], ["--stream", "--half"], ["--combine", "none", "--stream"],
     ["--combine", "walsh"]],
    ids=["memory", "stream", "half", "stream-half", "stream-none", "walsh"],
)
def test_cli_koosh_adjoint_matches_tron(tmp_path, on_cpu, extra):
    """tron-torch -3 -a vs tron -3 -a through .ra files; the streamed file
    equals the in-memory one byte for byte."""
    p = tmp_path / "d.ra"
    ra_write(_complex(9, (NC, 1, 32, 72, 3)), p)
    args = ["-3", "-a", "-G", "-u", "0.5"] + extra + [str(p)]
    a, b, c = (str(tmp_path / f"{k}.ra") for k in "abc")
    assert jcli.main(args + [a]) == 0
    assert cli.main(args + [b]) == 0
    ja, got = ra_read(a), ra_read(b)
    assert ra_query(b).dims == ra_query(a).dims and got.dtype == ja.dtype
    nc_out = NC if "none" in extra else 1
    assert got.shape[-5:] == (nc_out, 1, 16, 16, 3 * 4)
    if "--half" in extra:
        assert nrmse(got.astype(np.float32), ja.astype(np.float32)) <= F16_ULP
    else:
        assert nrmse(got, ja) <= 1e-5
    if "--stream" in extra:
        mem_args = [x for x in args if x != "--stream"]
        assert cli.main(mem_args + [c]) == 0
        np.testing.assert_array_equal(got, ra_read(c))


def test_cli_koosh_forward_and_notes(tmp_path, on_cpu, capsys):
    imgs = _complex(10, (NC, 1, 16, 16, 4))
    p = tmp_path / "img.ra"
    ra_write(imgs, p)
    a, b = str(tmp_path / "a.ra"), str(tmp_path / "b.ra")
    args = ["-3", "-G", "-u", "0.5", "--stream", "--compress", "1", str(p)]
    assert jcli.main(args + [a]) == 0
    jout = capsys.readouterr().out
    assert cli.main(args + [b]) == 0
    out = capsys.readouterr().out
    for note in ("note: --stream ignored (forward mode loads the input in memory)",
                 "note: --compress ignored (-3 recons all physical coils)"):
        assert note in out and note in jout
    assert ra_query(b).dims == ra_query(a).dims == (NC, 1, 32, 16, 4)
    assert nrmse(ra_read(b), ra_read(a)) <= 1e-5
