"""Forward/adjoint roundtrip on the analytic Shepp-Logan phantom, on the
PyTorch/CUDA port (the counterpart of `01_phantom_roundtrip.py`).

Synthesize golden-angle radial k-space from an image with the forward NUFFT
(degridding), reconstruct it with the adjoint (gridding + IFFT +
deapodization), and report accuracy.

Runs on the CUDA device; pass --cpu to ask for the CPU (the kernels' plain
torch versions).  Usage:

    python examples/torch_01_phantom_roundtrip.py [--n 128] [--npe 256] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=128, help="image size")
    p.add_argument("--npe", type=int, default=256, help="number of spokes")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    import torch

    from tron_tpu_torch import ReconConfig, nufft_adjoint, nufft_forward
    from tron_tpu_torch.device import resolve_device
    from tron_tpu_torch.phantom import shepp_logan
    from tron_tpu_torch.trajectory import spoke_angles

    dev = torch.device("cpu") if args.cpu else resolve_device()
    cfg = ReconConfig(golden_angle=True, sdc="ideal")
    img = shepp_logan(args.n).astype(np.complex64)
    angles = spoke_angles(args.npe, "golden", 0, device=dev)

    # image -> radial k-space (nc=1 leading axis; any leading axes batch)
    data = nufft_forward(torch.from_numpy(img[None]).to(dev), angles, cfg)
    # radial k-space -> image (SDC + gridding + centered IFFT + deapod)
    rec = nufft_adjoint(data, angles, cfg).cpu().numpy()[0]

    m, ref = np.abs(rec), np.abs(img)
    s = float(np.vdot(m, ref).real / np.vdot(m, m).real)  # ls scale
    err = np.linalg.norm(s * m - ref) / np.linalg.norm(ref)
    print(f"n={args.n} npe={args.npe}  roundtrip magnitude NRMSE: {err:.3e}")
    # plain-adjoint accuracy: Gibbs ringing off the phantom's edges plus
    # radial undersampling streaks dominate; 0.3 is a sanity gate
    return 0 if err < 0.3 else 1


if __name__ == "__main__":
    raise SystemExit(main())
