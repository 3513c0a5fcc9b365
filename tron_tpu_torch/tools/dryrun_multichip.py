"""Multi-device dry run of the sharded recons on tiny shapes (counterpart of
`dryrun_multichip` in `__graft_entry__.py`):

    python -m tron_tpu_torch.tools.dryrun_multichip N [--device cpu]

starts N ranks (`parallel/launch.py`; on the card one rank per visible card,
sharing cards when N is larger; with ``--device cpu`` N gloo ranks on the
CPU) and runs four checks in them, each against the unsharded port on the
same data at rtol 2e-4, atol 2e-5:

  1. frame x coil mesh, CGNR -i 1: the summed CG inner products on top of
     the coil combine's all_reduce;
  2. spoke mesh over all N ranks, CGNR -i 1 on one window, spokes padded;
  3. the incremental frame x coil scheduler at a block offset skip0 = 7 (the
     contract of --stream --shard --incremental);
  4. the `-3` slice-sharded adjoint with npe2 = N + 1 slices, which do not
     divide over the mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

RTOL, ATOL = 2e-4, 2e-5


def rank_checks(ctx, n_devices: int) -> list:
    """Worker: the four checks in one rank; returns their names."""
    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.parallel import (
        make_mesh,
        make_spoke_mesh,
        recon_frames_sharded,
        recon_stack_of_stars_sharded,
        recon_window_spoke_sharded,
    )
    from tron_tpu_torch.recon import recon_frames, recon_radial2d, reconstruct_frame

    dev = ctx.device
    n_coil = 2 if n_devices % 2 == 0 else 1
    n_frame = n_devices // n_coil
    mesh = make_mesh(n_frame=n_frame, n_coil=n_coil, device=dev)
    nc, nro = 2 * n_coil, 32
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=4, adjoint=True, niter=1)
    work = cfg.npe1work(nro, 10**9)  # 16
    nz = max(2 * n_frame - 1, 3)
    npe1 = work + (nz - 1) * 4
    rng = np.random.default_rng(0)
    data_np = (
        rng.standard_normal((nc, npe1, nro)) + 1j * rng.standard_normal((nc, npe1, nro))
    ).astype(np.complex64)
    data = torch.from_numpy(data_np).to(dev)
    done = []

    def check(name, got, want):
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        want = want.cpu().numpy() if isinstance(want, torch.Tensor) else want
        if got.shape != want.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{name}: shape {got.shape} (expected {want.shape}) or non-finite output")
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=ATOL, err_msg=f"{name} != single-device recon"
        )
        done.append(name)

    check("frame x coil CGNR", recon_frames_sharded(data, cfg, mesh, work, 4, nz),
          recon_frames(data, cfg, work, 4, nz))

    smesh = make_spoke_mesh(n_devices, device=dev)
    window = data[:, :work]
    check("spoke-sharded CGNR", recon_window_spoke_sharded(window, cfg, smesh),
          reconstruct_frame(window, cfg.skip_angles, cfg))

    cfg_inc = dataclasses.replace(cfg, niter=0, incremental=True)
    check("sharded incremental, skip0 7",
          recon_frames_sharded(data, cfg_inc, mesh, work, 4, nz, skip0=7),
          recon_frames(data, cfg_inc, work, 4, nz, skip0=7))

    cfg_k = ReconConfig(golden_angle=True, data_undersamp=0.5, adjoint=True, koosh=True)
    npe2 = n_devices + 1  # does not divide
    dk = (
        rng.standard_normal((nc, 1, nro, work, npe2))
        + 1j * rng.standard_normal((nc, 1, nro, work, npe2))
    ).astype(np.complex64)
    check("slice-sharded -3", recon_stack_of_stars_sharded(dk, cfg_k, mesh),
          recon_radial2d(dk, cfg_k, device=dev))
    return done


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 300.0) -> list:
    """Run the checks on ``n_devices`` ranks; returns each rank's RankResult."""
    from tron_tpu_torch.parallel import launch

    return launch.start_ranks(
        "tron_tpu_torch.tools.dryrun_multichip:rank_checks", n_devices,
        {"n_devices": n_devices}, device=device, timeout=timeout,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=300.0, help="seconds for the whole run")
    args = p.parse_args(argv)
    results = dryrun_multichip(args.n_devices, args.device, args.timeout)
    n_coil = 2 if args.n_devices % 2 == 0 else 1
    print(f"dryrun_multichip: {args.n_devices} ranks ({results[0].backend}, devices "
          f"{sorted({r.device for r in results})}), mesh frame {args.n_devices // n_coil} x coil "
          f"{n_coil}: {len(results[0].value)} checks passed on every rank: "
          f"{', '.join(results[0].value)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
