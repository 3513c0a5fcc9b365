"""The port's gridding (tron_tpu_torch.ops.grid, .grid_cuda) vs the JAX
package on the CPU.

The plain gridder is held to JAX's dense gridder, and the kernel wrapper's
CPU route to the Pallas windowed kernel `_win_kernel` itself, run in
interpret mode as the JAX package's own tests run it.  Inputs are numpy
arrays from seeds, handed to both packages.  The CUDA kernel has no CPU
mode: its tests are in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import nrmse
from tron_tpu.kernels.kb import kb_beta as jkb_beta
from tron_tpu.ops import grid as jgrid
from tron_tpu.ops import grid_pallas as jgrid_pallas
from tron_tpu.trajectory import spoke_angles as jangles
from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.ops import grid, grid_cuda

torch.set_num_threads(1)

KW = 2.0
BETA = kb_beta(KW, 2.0)


def _data(seed, C, npe, nro, signed=False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((C, npe, nro)) + 1j * rng.standard_normal((C, npe, nro))).astype(
        np.complex64
    )
    if signed:  # an incremental delta: the leaving half negated
        d[:, : npe // 2] *= -1
    return d


def _angles(npe, skip):
    return np.asarray(jangles(npe, "golden", skip))


def test_kb_beta_carried_over():
    assert BETA == jkb_beta(KW, 2.0)


@pytest.mark.parametrize("nxos", [64, 256])
def test_plain_grid_matches_jax(nxos):
    d = _data(10 + nxos, 2, 12, nxos, signed=True)
    ang = _angles(12, 19979)
    want = np.asarray(jgrid.grid_radial2d(jnp.asarray(d), jnp.asarray(ang), nxos, KW, BETA))
    got = grid.grid_radial2d(torch.from_numpy(d), torch.from_numpy(ang), nxos, KW, BETA)
    assert got.dtype == torch.complex64 and got.shape == (2, nxos, nxos)
    # fp32 sums in another order (tests/test_grid_pallas.py:43)
    assert nrmse(got.numpy(), want) <= 1e-5
    again = grid.grid_radial2d(torch.from_numpy(d), torch.from_numpy(ang), nxos, KW, BETA)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_plain_grid_raw_rows_matches_jax():
    d = _data(3, 1, 9, 96)
    ang = _angles(9, 5)
    want = np.asarray(
        jgrid.grid_radial2d(jnp.asarray(d), jnp.asarray(ang), 128, KW, BETA, raw_rows=True)
    )
    got = grid.grid_radial2d(
        torch.from_numpy(d), torch.from_numpy(ang), 128, KW, BETA, raw_rows=True
    )
    assert nrmse(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("nro,nxos", [(128, 128), (128, 192), (64, 128)])
def test_to_sample_planes_matches_jax(nro, nxos):
    d = _data(4, 3, 7, nro)
    want = np.asarray(jgrid_pallas.to_sample_planes(jnp.asarray(d), nxos))
    got = grid_cuda.to_sample_planes(torch.from_numpy(d), nxos)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("matmul_dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_planes_match_pallas_win_kernel(matmul_dtype, tol):
    """The wrapper's CPU route vs `_win_kernel` in interpret mode at nxos
    256 (the windowed kernel's smallest tiled grid), at the same precision
    class: the port rounds JAX's operands, so bfloat16 sits within the bf16
    flip noise of tests/test_torch_precision.py, not the bf16-vs-fp32 gap."""
    nxos = 256
    d = _data(5, 1, 12, nxos)
    ang = _angles(12, 20055)
    jplanes = jgrid_pallas.to_sample_planes(jnp.asarray(d), nxos)
    want = np.asarray(
        jgrid_pallas.grid_radial2d_pallas_planes(
            jplanes, jnp.asarray(ang), nxos, KW, BETA, matmul_dtype=matmul_dtype,
            interpret=True,
        )
    )
    planes = torch.from_numpy(np.asarray(jplanes))
    launches = grid_cuda.LAUNCHES
    got = grid_cuda.grid_radial2d_planes(
        planes, torch.from_numpy(ang), nxos, KW, BETA, matmul_dtype=matmul_dtype
    )
    assert grid_cuda.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.complex64 and got.shape == (1, nxos, nxos)
    assert nrmse(got.numpy(), want) <= tol


def test_planes_form_equals_complex_form():
    nxos = 128
    d = torch.from_numpy(_data(6, 2, 10, nxos, signed=True))
    ang = torch.from_numpy(_angles(10, 7))
    dense = grid.grid_radial2d(d, ang, nxos, KW, BETA, pe_chunk=8)
    planes = grid.grid_radial2d_planes_plain(
        grid_cuda.to_sample_planes(d, nxos), ang, nxos, KW, BETA
    )
    assert nrmse(planes.numpy(), dense.numpy()) <= 1e-6
    entry = grid_cuda.grid_radial2d(d, ang, nxos, KW, BETA, pe_chunk=8)
    np.testing.assert_array_equal(entry.numpy(), dense.numpy())
    one = grid_cuda.grid_radial2d(d[0], ang, nxos, KW, BETA, pe_chunk=8)
    np.testing.assert_array_equal(one.numpy(), dense[0].numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    planes = torch.zeros((4, 64, 2))
    ang = torch.zeros(4)
    with pytest.raises(ValueError, match="matmul_dtype"):
        grid_cuda.grid_radial2d_planes(planes, ang, 64, KW, BETA, matmul_dtype="fp8")
    with pytest.raises(ValueError, match="nxos"):
        grid_cuda._check_planes(planes, ang, 128)
    with pytest.raises(ValueError, match="float32"):
        grid_cuda._check_planes(planes.double(), ang, 64)
    with pytest.raises(ValueError, match="contiguous"):
        grid_cuda._check_planes(torch.zeros((4, 2, 64)).transpose(1, 2), ang, 64)
    with pytest.raises(ValueError, match="angles"):
        grid_cuda._check_planes(planes, torch.zeros(5), 64)


def test_kernel_tuning_from_env_matches_jax(monkeypatch):
    from tron_tpu.config import KernelTuning as JaxTuning
    from tron_tpu_torch.config import KernelTuning

    monkeypatch.delenv("TRON_BATCHED", raising=False)
    assert KernelTuning.from_env().batched is JaxTuning.from_env().batched is False
    for v in ("1", "0", "2"):
        monkeypatch.setenv("TRON_BATCHED", v)
        assert KernelTuning.from_env().batched == JaxTuning.from_env().batched


@pytest.mark.parametrize("batched", [None, False, True])
def test_from_jax_fields_carries_batched(monkeypatch, batched):
    """A JAX config's tuning arrives with its ``batched`` (the Mosaic/VMEM
    fields are dropped); None stays None and resolves from the env."""
    import dataclasses

    from tron_tpu.config import KernelTuning as JaxTuning
    from tron_tpu.config import ReconConfig as JaxConfig
    from tron_tpu_torch.config import KernelTuning, ReconConfig

    monkeypatch.setenv("TRON_BATCHED", "1")
    jt = None if batched is None else JaxTuning(batched=batched, ws=24, vmem_limit=1 << 24)
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(JaxConfig(tuning=jt)))
    if batched is None:
        assert cfg.tuning is None and cfg.kernel_tuning() == KernelTuning(batched=True)
    else:
        assert cfg.tuning == KernelTuning(batched=batched)
        assert cfg.kernel_tuning().batched is batched
    hash(cfg)  # still a frozen, hashable config


def test_batched_planes_match_pallas_win_kernel_batched():
    """The planes path under tuning.batched (the tensor-core kernel's CPU
    route: its plain version, the planes gridder) vs JAX's
    `_win_kernel_batched` in interpret mode, float32, nxos 256, C 2, npe 12."""
    from tron_tpu.config import KernelTuning as JaxTuning
    from tron_tpu_torch.config import KernelTuning

    nxos = 256
    d = _data(8, 2, 12, nxos, signed=True)
    ang = _angles(12, 20013)
    jplanes = jgrid_pallas.to_sample_planes(jnp.asarray(d), nxos)
    want = np.asarray(
        jgrid_pallas.grid_radial2d_pallas_planes(
            jplanes, jnp.asarray(ang), nxos, KW, BETA, pe_chunk=4, matmul_dtype="float32",
            interpret=True, tuning=JaxTuning(batched=True),
        )
    )
    planes = torch.from_numpy(np.asarray(jplanes))
    launches = dict(grid_cuda.LAUNCH_COUNTS)
    got = grid_cuda.grid_radial2d_planes(
        planes, torch.from_numpy(ang), nxos, KW, BETA, tuning=KernelTuning(batched=True)
    )
    assert grid_cuda.LAUNCH_COUNTS == launches
    assert nrmse(got.numpy(), want) <= 1e-5
    loop = grid_cuda.grid_radial2d_planes(planes, torch.from_numpy(ang), nxos, KW, BETA)
    np.testing.assert_array_equal(got.numpy(), loop.numpy())


def test_launch_counts_per_kernel():
    """One count per kernel; LAUNCHES reads their total, reset_launches
    zeroes them."""
    saved = dict(grid_cuda.LAUNCH_COUNTS)
    try:
        assert set(grid_cuda.LAUNCH_COUNTS) == set(grid_cuda.KERNELS) == {
            "grid_radial2d", "grid_radial2d_batched", "grid_seg_radial2d"}
        grid_cuda.LAUNCH_COUNTS.update(grid_radial2d=2, grid_seg_radial2d=3)
        assert grid_cuda.LAUNCHES == 5
        grid_cuda.reset_launches()
        assert grid_cuda.LAUNCHES == 0
        with pytest.raises(AttributeError):
            grid_cuda.NO_SUCH_COUNT
    finally:
        grid_cuda.LAUNCH_COUNTS.update(saved)


@pytest.mark.parametrize("nxos", [64, 100])
def test_complex_entry_windowed_false_on_cpu(nxos):
    """windowed=False takes the segmented plain gridder on a CPU tensor
    (any nxos; JAX's `_seg_kernel` needs two 128-wide tiles)."""
    d = torch.from_numpy(_data(9, 2, 10, nxos, signed=True))
    ang = torch.from_numpy(_angles(10, 11))
    culled = grid_cuda.grid_radial2d(d, ang, nxos, KW, BETA, windowed=False)
    dense = grid_cuda.grid_radial2d(d, ang, nxos, KW, BETA)
    assert nrmse(culled.numpy(), dense.numpy()) <= 1e-6
    one = grid_cuda.grid_radial2d(d[0], ang, nxos, KW, BETA, windowed=False)
    np.testing.assert_array_equal(one.numpy(), culled[0].numpy())
