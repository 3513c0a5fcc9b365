"""The port's coil operators (tron_tpu_torch.ops.coil: the box filter, the
Walsh adaptive combine, SVD coil compression) vs the JAX package on the CPU.

Inputs are numpy arrays from seeds, handed to both packages.  Compressed
data is compared through its root-sum-of-squares and through the projector
basis @ basis^H: eigenvectors are fixed only up to a phase.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu.ops import coil as jcoil
from tron_tpu_torch.ops import coil

torch.set_num_threads(1)


def _complex(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _coil_images(seed, C, n=24):
    """Smooth sensitivities times one image plus noise: a dominant
    eigenvector per pixel, as coil images have."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n] / n
    img = np.exp(-((x - 0.4) ** 2 + (y - 0.6) ** 2) / 0.05) + 0.2
    sens = np.stack([np.exp(2j * np.pi * (c * x + (C - c) * y) / C) * (1 + 0.3 * c * x)
                     for c in range(C)])
    noise = 0.05 * (rng.standard_normal((C, n, n)) + 1j * rng.standard_normal((C, n, n)))
    return (sens * img + noise).astype(np.complex64)


@pytest.mark.parametrize("npatch", [0, 1, 2, 3])
def test_box_filter_matches_jax(npatch):
    x = _complex(npatch, (3, 2, 17, 20))
    want = np.asarray(jcoil._box_filter(jnp.asarray(x), npatch))
    got = coil._box_filter(torch.from_numpy(x), npatch).numpy()
    assert got.shape == want.shape
    assert nrmse(got, want) <= 1e-6
    if npatch == 1:  # zero padding: a corner sums its 2x2 neighbourhood
        np.testing.assert_allclose(got[0, 0, 0, 0], x[0, 0, :2, :2].sum(), rtol=1e-5)


@pytest.mark.parametrize("npatch", [0, 1, 2])
@pytest.mark.parametrize("C", [2, 4, 6])
def test_walsh_matches_jax(C, npatch):
    ci = _coil_images(10 * C + npatch, C)
    want = np.asarray(jcoil.coil_combine_walsh(jnp.asarray(ci), npatch))
    got = coil.coil_combine_walsh(torch.from_numpy(ci), npatch).numpy()
    assert got.shape == want.shape == ci.shape[1:] and got.dtype == np.complex64
    assert nrmse(got, want) <= 1e-5


def test_walsh_single_coil_and_zero_pixels():
    ci = _coil_images(1, 1)
    np.testing.assert_array_equal(coil.coil_combine_walsh(torch.from_numpy(ci)).numpy(), ci[0])
    # a pixel whose whole patch is zero keeps a zero vector: no NaN (the
    # nrm > 0 guard), as in JAX
    z = _coil_images(2, 3)
    z[:, :6, :6] = 0
    got = coil.coil_combine_walsh(torch.from_numpy(z), 1).numpy()
    want = np.asarray(jcoil.coil_combine_walsh(jnp.asarray(z), 1))
    assert np.isfinite(got).all() and got[2, 2] == 0
    assert nrmse(got, want) <= 1e-5


def test_walsh_frames_equals_per_frame_and_jax():
    stack = np.stack([_coil_images(20 + z, 4, n=16) for z in range(3)])
    got = coil.coil_combine_walsh_frames(torch.from_numpy(stack), 1).numpy()
    for z in range(3):
        one = coil.coil_combine_walsh(torch.from_numpy(stack[z]), 1).numpy()
        np.testing.assert_array_equal(got[z], one)
    want = np.asarray(jcoil.coil_combine_walsh_frames(jnp.asarray(stack), 1))
    assert nrmse(got, want) <= 1e-5
    single = coil.coil_combine_walsh_frames(torch.from_numpy(stack[:, :1]))
    np.testing.assert_array_equal(single.numpy(), stack[:, 0])


def _kspace(seed, C, shape=(12, 16)):
    """(C, npe, nro) k-space whose coil Gram matrix has the eigenvalues
    linspace(1, 0.3, C)^2 exactly (orthonormal sample rows, a unitary coil
    mix): the eigenvectors of a float32 Gram matrix are good to about
    eps * |G| / gap, and the projector below is recovered through X's
    pseudo-inverse, so the gaps are wide and X is well conditioned."""
    M = shape[0] * shape[1]
    rows = np.linalg.qr(_complex(seed, (M, C)).astype(np.complex128))[0].T      # (C, M)
    mix = np.linalg.qr(_complex(seed + 1, (C, C)).astype(np.complex128))[0]
    X = mix @ (np.linspace(1.0, 0.3, C)[:, None] * rows)
    return (np.sqrt(M) * X).reshape((C,) + shape).astype(np.complex64)


@pytest.mark.parametrize("C,ncomp", [(4, 2), (6, 3), (8, 1)])
def test_coil_compress_matches_jax(C, ncomp):
    d = _kspace(C, C)
    want = np.asarray(jcoil.coil_compress(jnp.asarray(d), ncomp))
    got = coil.coil_compress(torch.from_numpy(d), ncomp).numpy()
    assert got.shape == want.shape == (ncomp,) + d.shape[1:]
    # the virtual coils' root-sum-of-squares
    sos = lambda a: np.sqrt((np.abs(a) ** 2).sum(axis=0))  # noqa: E731
    assert nrmse(sos(got), sos(want)) <= 1e-5
    # the projector basis @ basis^H, recovered from Y = basis^H X by least
    # squares (X has full row rank)
    X = d.reshape(C, -1).astype(np.complex128)
    proj = []
    for Y in (got, want):
        BH = Y.reshape(ncomp, -1).astype(np.complex128) @ np.linalg.pinv(X)   # (ncomp, C)
        proj.append(BH.conj().T @ BH)
    np.testing.assert_allclose(proj[0], proj[1], atol=1e-5)
    np.testing.assert_allclose(proj[0] @ proj[0], proj[0], atol=1e-4)  # a projector


def test_coil_compress_keeps_the_energy_order_and_passes_through():
    d = _kspace(3, 5)
    got = coil.coil_compress(torch.from_numpy(d), 3).numpy()
    energy = (np.abs(got) ** 2).sum(axis=(1, 2))
    want = np.linspace(1.0, 0.3, 5) ** 2 * d[0].size      # descending eigenvalues
    np.testing.assert_allclose(energy, want[:3], rtol=1e-4)
    t = torch.from_numpy(d)
    assert coil.coil_compress(t, 5) is t and coil.coil_compress(t, 7) is t
