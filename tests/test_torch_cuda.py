"""The port's CUDA gridding kernel vs its plain torch version, on the card.

Every test here is marked `gpu` and skips without a CUDA device: the kernel
has no CPU mode.  The file imports nothing of JAX or of tests/conftest.py,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tron_tpu_torch.kernels.kb import kb_beta
from tron_tpu_torch.ops import grid_cuda
from tron_tpu_torch.ops.grid import grid_radial2d, grid_radial2d_planes_plain
from tron_tpu_torch.trajectory import spoke_angles

torch.set_num_threads(1)

KW = 2.0
BETA = kb_beta(KW, 2.0)
TOL = 1e-5  # NRMSE: the same fp32 terms summed in two orders


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gridding kernel has no CPU mode")
    # the plain version is the fp32 oracle: no TF32 in its matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _nrmse(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "nxos,C,npe,skip",
    [(64, 1, 8, 5), (128, 2, 12, 5), (256, 2, 48, 9000), (512, 6, 204, 19000), (128, 10, 1500, 0)],
)
def test_kernel_matches_plain(dev, nxos, C, npe, skip):
    rng = np.random.default_rng(nxos + npe)
    planes = torch.from_numpy(rng.standard_normal((npe, nxos, 2 * C), dtype=np.float32)).to(dev)
    planes[: npe // 2] *= -1  # signed, as in an incremental delta
    ang = spoke_angles(npe, "golden", skip, device=dev)
    launches = grid_cuda.LAUNCHES
    got = grid_cuda.grid_radial2d_planes(planes, ang, nxos, KW, BETA)
    again = grid_cuda.grid_radial2d_planes(planes, ang, nxos, KW, BETA)
    want = grid_radial2d_planes_plain(planes, ang, nxos, KW, BETA)
    torch.cuda.synchronize()
    assert grid_cuda.LAUNCHES == launches + 2
    assert got.shape == (C, nxos, nxos) and got.dtype == torch.complex64
    assert _nrmse(got, want) <= TOL
    assert torch.equal(got, again)  # fixed summation order, no atomics


@pytest.mark.gpu
def test_complex_entry_matches_dense(dev):
    rng = np.random.default_rng(1)
    d = rng.standard_normal((2, 12, 128)) + 1j * rng.standard_normal((2, 12, 128))
    d = torch.from_numpy(d.astype(np.complex64)).to(dev)
    ang = spoke_angles(12, "golden", 5, device=dev)
    got = grid_cuda.grid_radial2d(d, ang, 128, KW, BETA)
    assert _nrmse(got, grid_radial2d(d, ang, 128, KW, BETA)) <= TOL


@pytest.mark.gpu
def test_wrapper_raises_on_bad_input(dev):
    planes = torch.zeros((4, 64, 3), device=dev)
    with pytest.raises(ValueError):
        grid_cuda.grid_radial2d_planes(planes, torch.zeros(4, device=dev), 64, KW, BETA)
    with pytest.raises(ValueError):
        grid_cuda.grid_radial2d_planes(
            torch.zeros((4, 64, 2), device=dev), torch.zeros(4), 64, KW, BETA
        )
