"""Multi-device sliding-window recon on a ('frame', 'coil') process mesh, on
the PyTorch/CUDA port (the counterpart of `03_sharded_recon.py`).

Frames are independent, so they shard over the 'frame' mesh axis with no
traffic between devices; coils shard over 'coil' and the sum-of-squares
combine finishes with one all_reduce.  One process drives one device
(`tron_tpu_torch/parallel/`): with --cpu this starts 8 gloo ranks on the CPU
as a 4 x 2 mesh, so it runs on any machine; without it, one rank per visible
CUDA device (coil 2 when their number is even).

    python examples/torch_03_sharded_recon.py [--n 64] [--frames 16] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

WORK, SLIDE, NC = 32, 8, 2


def rank_recon(ctx, n: int, frames: int, n_coil: int) -> float:
    """Worker, run by every rank: synthesize the acquisition, reconstruct it
    sharded and unsharded, return the NRMSE between the two."""
    import torch

    from tron_tpu_torch import ReconConfig, nufft_forward
    from tron_tpu_torch.parallel import make_mesh, recon_frames_sharded
    from tron_tpu_torch.phantom import birdcage_sensitivities, shepp_logan
    from tron_tpu_torch.recon import recon_frames
    from tron_tpu_torch.trajectory import spoke_angles

    npe1 = WORK + (frames - 1) * SLIDE
    # synthesize a sliding-window multicoil acquisition
    cfg = ReconConfig(golden_angle=True, adjoint=True)
    img = shepp_logan(n) * birdcage_sensitivities(n, NC)
    angles = spoke_angles(npe1, "golden", 0, device=ctx.device)
    data = nufft_forward(torch.from_numpy(img.astype(np.complex64)).to(ctx.device), angles, cfg)

    mesh = make_mesh(n_frame=ctx.world // n_coil, n_coil=n_coil, device=ctx.device)
    out = recon_frames_sharded(data, cfg, mesh, WORK, SLIDE, frames)
    ref = recon_frames(data, cfg, WORK, SLIDE, frames)
    return float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--cpu", action="store_true", help="8 gloo ranks on the CPU")
    args = p.parse_args(argv)

    import torch

    from tron_tpu_torch.parallel import launch

    world = 8 if args.cpu else torch.cuda.device_count()
    n_coil = 2 if world % 2 == 0 else 1
    results = launch.start_ranks(
        "examples.torch_03_sharded_recon:rank_recon", world,
        {"n": args.n, "frames": args.frames, "n_coil": n_coil},
        device="cpu" if args.cpu else "cuda",
    )
    print(f"mesh: {{'frame': {world // n_coil}, 'coil': {n_coil}}} on {world} ranks "
          f"({results[0].backend}; {sorted({r.device for r in results})})")
    err = max(r.value for r in results)
    print(f"{args.frames} frames sharded over DP(frame)={world // n_coil} x TP(coil)={n_coil}; "
          f"NRMSE vs single-device: {err:.2e}")
    return 0 if err < 1e-5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
