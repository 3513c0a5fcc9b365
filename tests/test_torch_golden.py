"""Golden images for the PyTorch port: JAX's float32 sum-of-squares recon of a
seed-made golden-angle input (nro 256, 2 coils, -u 0.4 -d 21, 3 frames),
stored in tests/data/torch_port_golden.npz.  The input is not stored; it is
regenerated from the seed in the file.  JAX's current output and the
port's CPU output must both match the stored images; `chip_smoke.py` holds
the port on the card to the same file.

Regenerate the file from the repo root with `python -m tests.test_torch_golden`.
"""

import dataclasses
import os

import numpy as np
import torch

from tests.conftest import nrmse

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden.npz")
SEED, NC, NRO, SLIDE, UNDERSAMP, NZ = 20261016, 2, 256, 21, 0.4, 3


def golden_input(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _jax_images(indata, slide, undersamp):
    from tron_tpu.config import ReconConfig
    from tron_tpu.recon import recon_radial2d

    cfg = ReconConfig(golden_angle=True, data_undersamp=undersamp, prof_slide=slide,
                      adjoint=True, backend="jnp")
    return cfg, np.abs(recon_radial2d(indata, cfg)[:, 0]).astype(np.float32)


def test_golden_jax_and_port():
    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.recon import recon_radial2d

    g = np.load(GOLDEN)
    indata = golden_input(int(g["seed"]), tuple(int(s) for s in g["shape"]))
    jcfg, jax_img = _jax_images(indata, int(g["slide"]), float(g["undersamp"]))
    assert g["images"].shape == (NZ, NRO // 2, NRO // 2)
    assert nrmse(jax_img, g["images"]) <= 1e-5
    cfg = ReconConfig.from_jax_fields(dataclasses.asdict(jcfg))
    port = recon_radial2d(indata, dataclasses.replace(cfg, backend="auto"), device="cpu")
    assert port.shape == (NZ, 1, NRO // 2, NRO // 2)
    assert nrmse(np.abs(port[:, 0]), g["images"]) <= 1e-5


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    work = int(NRO * UNDERSAMP)
    shape = (NC, 1, NRO, work + (NZ - 1) * SLIDE)
    _, images = _jax_images(golden_input(SEED, shape), SLIDE, UNDERSAMP)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez(GOLDEN, images=images, seed=SEED, shape=np.array(shape),
             slide=SLIDE, undersamp=UNDERSAMP)
    print(f"wrote {GOLDEN}: images {images.shape}")
