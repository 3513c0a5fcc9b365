"""Multicoil recon on the PyTorch/CUDA port: plain adjoint vs iterative CGNR
(the counterpart of `02_cgnr_and_coils.py`).

Simulate a 4-coil golden-angle acquisition with birdcage sensitivities,
reconstruct with

  1. the plain adjoint NUFFT + root-sum-of-squares combine,
  2. CGNR on the normal equations (the kernel pair on the card, the autograd
     transpose of the plain forward on the CPU),
  3. CGNR with the Toeplitz-embedded normal operator (two FFT pairs per
     iteration, no degrid/grid),

and compare against the ground-truth phantom.  Usage:

    python examples/torch_02_cgnr_and_coils.py [--n 96] [--npe 144] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=96)
    p.add_argument("--npe", type=int, default=144)
    p.add_argument("--niter", type=int, default=8)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from tron_tpu_torch import ReconConfig, cgnr_radial2d, nufft_adjoint, nufft_forward
    from tron_tpu_torch.device import resolve_device
    from tron_tpu_torch.ops.coil import coil_combine_sos
    from tron_tpu_torch.phantom import birdcage_sensitivities, shepp_logan
    from tron_tpu_torch.trajectory import spoke_angles

    dev = torch.device("cpu") if args.cpu else resolve_device()
    nc = 4
    img = shepp_logan(args.n).astype(np.complex64)
    maps = birdcage_sensitivities(args.n, nc)              # (nc, n, n)
    coils = maps * img[None]
    angles = spoke_angles(args.npe, "golden", 0, device=dev)

    cfg = ReconConfig(golden_angle=True, sdc="ideal", niter=args.niter)
    data = nufft_forward(torch.from_numpy(coils.astype(np.complex64)).to(dev), angles, cfg)

    ref = np.abs(img) * np.linalg.norm(maps, axis=0)  # SoS-weighted truth

    def nrmse(x):
        m = np.abs(x.cpu().numpy())
        s = float(np.vdot(m, ref).real / np.vdot(m, m).real)  # ls scale
        return float(np.linalg.norm(s * m - ref) / np.linalg.norm(ref))

    adj = coil_combine_sos(nufft_adjoint(data, angles, cfg))
    print(f"adjoint + SoS        NRMSE {nrmse(adj):.3e}")

    cg = coil_combine_sos(cgnr_radial2d(data, angles, cfg))
    print(f"CGNR (pair, {args.niter} it)   NRMSE {nrmse(cg):.3e}")

    cfg_t = dataclasses.replace(cfg, toeplitz=True)
    cgt = coil_combine_sos(cgnr_radial2d(data, angles, cfg_t))
    print(f"CGNR (Toeplitz)      NRMSE {nrmse(cgt):.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
