"""The port's framework-free math vs the JAX package on the CPU: config
carry-over, KB kernel, trajectory, FFT chain, SoS combine, device selection
and .ra I/O.  Inputs are numpy arrays from seeds, handed to both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tron_tpu import config as jconfig
from tron_tpu import trajectory as jtraj
from tron_tpu.io import ra as jra
from tron_tpu.kernels import kb as jkb
from tron_tpu.ops import coil as jcoil
from tron_tpu.ops import fftops as jfft
from tron_tpu_torch import config, trajectory
from tron_tpu_torch.device import resolve_device
from tron_tpu_torch.io import ra
from tron_tpu_torch.kernels import kb
from tron_tpu_torch.ops import coil, fftops

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize(
    "jcfg",
    [
        jconfig.ReconConfig(),
        jconfig.ReconConfig(
            golden_angle=True, data_undersamp=0.4, prof_slide=21, adjoint=True,
            kernwidth=1.5, gridos=1.5, sdc="ideal", incremental=True,
            backend="jnp", matmul_dtype="float32", dft_dot="highest",
            tuning=jconfig.KernelTuning(ws=24),
        ),
    ],
)
def test_config_from_jax_fields(jcfg):
    d = dataclasses.asdict(jcfg)
    cfg = config.ReconConfig.from_jax_fields(d)
    want = {k: v for k, v in d.items() if k != "dft_dot"}
    # the tuning keeps only `batched`; the TPU's VMEM/Mosaic knobs are dropped
    want["tuning"] = None if d["tuning"] is None else {"batched": d["tuning"]["batched"]}
    assert dataclasses.asdict(cfg) == want
    assert cfg.frame_geometry(512, 20259) == jcfg.frame_geometry(512, 20259)
    assert cfg.scheme_for("adjoint") == jcfg.scheme_for("adjoint")
    assert config.PHI == jconfig.PHI
    with pytest.raises(TypeError):
        config.ReconConfig.from_jax_fields({**d, "not_a_field": 1})


@pytest.mark.parametrize("kw,beatty", [(2.0, False), (1.5, False), (3.0, True)])
def test_kb_matches_jax(kw, beatty):
    beta = kb.kb_beta(kw, 2.0, beatty)
    assert beta == pytest.approx(jkb.kb_beta(kw, 2.0, beatty), rel=1e-12)
    x = np.random.default_rng(0).uniform(-1.2 * kw, 1.2 * kw, 4096).astype(np.float32)
    u = np.linspace(-0.5, 0.5, 1001, dtype=np.float32)
    i0x = np.abs(x) * beta / kw
    assert _rel(kb.besseli0(_t(i0x)).numpy(), np.asarray(jkb.besseli0(jnp.asarray(i0x)))) <= 1e-6
    assert _rel(
        kb.kb_kernel(_t(x), kw, beta).numpy(), np.asarray(jkb.kb_kernel(jnp.asarray(x), kw, beta))
    ) <= 1e-6
    # kb_hat's sinh(z)/z at z ~ beta: XLA's float32 sinh is itself up to
    # ~1.1e-6 from the float64 value here (kw 3), so the port is held to the
    # float64 value at 1e-6 and to JAX at the sum of the two float32 errors
    hat = kb.kb_hat(_t(u), kw, beta).numpy()
    q = (np.pi * 2 * kw * u.astype(np.float64)) ** 2 - beta**2
    z = np.sqrt(np.abs(q))
    exact = np.where(q > 0, np.sin(z) / z, np.sinh(z) / z)
    assert _rel(hat, exact) <= 1e-6
    assert _rel(hat, np.asarray(jkb.kb_hat(jnp.asarray(u), kw, beta))) <= 2e-6


@pytest.mark.parametrize(
    "scheme,skip",
    [("golden", 0), ("golden", 5), ("golden", 19979), ("golden", 20055),
     ("linear_half", 0), ("linear_full", 0)],
)
def test_spoke_angles_match_jax(scheme, skip):
    got = trajectory.spoke_angles(204, scheme, skip).numpy()
    want = np.asarray(jtraj.spoke_angles(204, scheme, skip))
    assert got.dtype == np.float32
    # golden angles at whole-body offsets: within one float32 ulp
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want).astype(np.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_modang_matches_jnp_mod():
    x = np.random.default_rng(1).uniform(-5e4, 5e4, 8192).astype(np.float32)
    got = trajectory.modang(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtraj.modang(jnp.asarray(x))))
    assert got.min() >= 0 and got.max() <= 2 * np.pi


@pytest.mark.parametrize("nro,npe", [(128, 51), (512, 204)])
def test_sdc_and_radii_match_jax(nro, npe):
    for ours, theirs in (
        (trajectory.ramlak_sdc(nro, npe), jtraj.ramlak_sdc(nro, npe)),
        (trajectory.ideal_sdc(nro, npe), jtraj.ideal_sdc(nro, npe)),
        (trajectory.sample_radii(nro, nro), jtraj.sample_radii(nro, nro)),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-7)


def test_fftops_match_jax():
    rng = np.random.default_rng(2)
    img = (rng.standard_normal((2, 64, 64)) + 1j * rng.standard_normal((2, 64, 64))).astype(
        np.complex64
    )
    beta = kb.kb_beta(2.0, 2.0)
    pairs = [
        (fftops.centered_fft2(_t(img)), jfft.centered_fft2(jnp.asarray(img))),
        (fftops.centered_ifft2_unnormalized(_t(img)),
         jfft.centered_ifft2_unnormalized(jnp.asarray(img))),
        (fftops.crop_center(_t(img), 32), jfft.crop_center(jnp.asarray(img), 32)),
        (fftops.pad_center(_t(img[..., :40, :40]), 64),
         jfft.pad_center(jnp.asarray(img[..., :40, :40]), 64)),
        (fftops.deapod_weights(32, 64, 2.0, beta), jfft.deapod_weights(32, 64, 2.0, beta)),
        (fftops.deapodize(_t(img[..., :32, :32]), 64, 2.0, beta),
         jfft.deapodize(jnp.asarray(img[..., :32, :32]), 64, 2.0, beta)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-5


def test_coil_sos_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 16, 16)) + 1j * rng.standard_normal((4, 16, 16))).astype(
        np.complex64
    )
    got = coil.coil_combine_sos(_t(x))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jcoil.coil_combine_sos(jnp.asarray(x))), rtol=1e-6
    )
    one = coil.coil_combine_sos(_t(x[:1]))
    np.testing.assert_array_equal(one.numpy(), x[0])


def test_resolve_device_never_substitutes_cpu():
    index = 10**6 if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(index)


@pytest.mark.parametrize("dtype", [np.complex64, np.float16, np.int32])
def test_ra_bytes_match_jax(tmp_path, dtype):
    arr = (np.random.default_rng(4).standard_normal((3, 2, 5)) * 100).astype(dtype)
    ours, theirs = tmp_path / "ours.ra", tmp_path / "theirs.ra"
    ra.ra_write(arr, ours)
    jra.ra_write(arr, theirs)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(ra.ra_read(theirs), arr)
    assert ra.ra_query(ours).dims == (3, 2, 5)
