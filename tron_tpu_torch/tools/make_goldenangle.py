"""Synthesize a golden-angle multicoil radial acquisition .ra file, the
stand-in for the reference's datasets (ex_whole_body / optic_nerve /
swallowing: dims (nc, nt, nro, npe1, 1), e.g. 6x1x512x20271 for whole-body)
(counterpart of `tron_tpu/tools/make_goldenangle.py`):

    python -m tron_tpu_torch.tools.make_goldenangle ga.ra --nc 4 --nro 128 --npe 96

Data = forward NUFFT of the coil-weighted Shepp-Logan phantom at the
requested spoke count, so adjoint recons of any sliding window see
consistent anatomy.  Runs on the card (`--device N`, the degridding kernel)
or, with `--device cpu`, on the CPU (its plain version).
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("outfile")
    p.add_argument("--nc", type=int, default=6)
    p.add_argument("--nro", type=int, default=512)
    p.add_argument("--npe", type=int, default=1479)
    p.add_argument("--chunk", type=int, default=512, help="spokes per forward call")
    p.add_argument("--device", default="0", help="CUDA device index, or 'cpu'")
    args = p.parse_args(argv)

    import torch

    from tron_tpu_torch.config import AngleScheme, ReconConfig
    from tron_tpu_torch.device import parse_device
    from tron_tpu_torch.io import ra_write
    from tron_tpu_torch.nufft import nufft_forward
    from tron_tpu_torch.phantom import birdcage_sensitivities, shepp_logan
    from tron_tpu_torch.trajectory import spoke_angles

    device = parse_device(args.device)
    n = args.nro // 2
    coilimg = torch.from_numpy(birdcage_sensitivities(n, args.nc) * shepp_logan(n)[None])
    coilimg = coilimg.to(device)  # (nc, n, n)

    cfg = ReconConfig(golden_angle=True)
    chunks = []
    for pe0 in range(0, args.npe, args.chunk):
        npe = min(args.chunk, args.npe - pe0)
        angles = spoke_angles(npe, AngleScheme.GOLDEN, pe0, device=device)
        chunks.append(nufft_forward(coilimg, angles, cfg, nro=args.nro).cpu().numpy())
    data = np.concatenate(chunks, axis=1)  # (nc, npe, nro)

    # .ra dims (nc, nt, nro, npe1, npe2), nc fastest
    arr = np.transpose(data, (0, 2, 1))[:, None, :, :, None].astype(np.complex64)
    ra_write(arr, args.outfile)
    print(f"wrote {args.outfile} dims={arr.shape}")


if __name__ == "__main__":
    main()
