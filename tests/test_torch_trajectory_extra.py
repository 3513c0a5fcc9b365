"""The port's remaining trajectory helpers (tron_tpu_torch.trajectory
minangulardist and grid_radius_to_ro) vs the JAX package's on the CPU, on
the same seeded inputs."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tron_tpu import trajectory as jtraj
from tron_tpu_torch import trajectory

torch.set_num_threads(1)


@pytest.mark.parametrize("lo,hi", [(0.0, 2 * math.pi), (-8 * math.pi, 8 * math.pi)])
def test_minangulardist_matches_jax(lo, hi):
    """1000 seeded float32 angle pairs in [lo, hi): within 1e-6 of JAX.  On
    wrapped angles (the reference's domain, [0, 2 pi)) no two spokes lie
    farther apart than pi/2, since a and a+pi are one spoke; outside it the
    reference's formula (b is not wrapped) goes negative, in both."""
    rng = np.random.default_rng(7)
    a = rng.uniform(lo, hi, 1000).astype(np.float32)
    b = rng.uniform(lo, hi, 1000).astype(np.float32)
    want = np.asarray(jtraj.minangulardist(jnp.asarray(a), jnp.asarray(b)))
    got = trajectory.minangulardist(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if lo == 0.0:
        assert 0 <= float(got.min()) and float(got.max()) <= math.pi / 2 + 1e-6


def test_minangulardist_same_spoke_is_zero():
    """A spoke and its reverse (a + pi) lie on one line: distance 0 up to
    the float32 wrap, as in JAX."""
    a = np.linspace(0, 6, 50, dtype=np.float32)
    for b in (a, a + np.float32(math.pi)):
        want = np.asarray(jtraj.minangulardist(jnp.asarray(a), jnp.asarray(b)))
        got = trajectory.minangulardist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert float(np.abs(got).max()) <= 1e-5


@pytest.mark.parametrize("nro,nxos", [(16, 16), (64, 128), (512, 768)])
def test_grid_radius_to_ro_equals_jax(nro, nxos):
    """Every integer grid radius of the grid, and a few beyond it: the same
    int32 readout index as JAX (C truncation of the float32 product)."""
    r = np.arange(-nxos // 2 - 3, nxos // 2 + 3, dtype=np.int32)
    want = np.asarray(jtraj.grid_radius_to_ro(jnp.asarray(r), nro, nxos))
    got = trajectory.grid_radius_to_ro(torch.from_numpy(r), nro, nxos)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if nro == nxos:
        np.testing.assert_array_equal(got.numpy(), r + nro // 2)
