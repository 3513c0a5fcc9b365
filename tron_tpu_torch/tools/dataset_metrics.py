"""SSIM/NMSE table for dataset-study recons (counterpart of
`scripts/dataset_metrics.py`; the role of the RUNME4-7 MATLAB tables,
`src/RUNME4_others_grid_slcmt.m:283-312`, which score TRON against IRT on
the same data).  For each requested frame this recomputes the recon of the
same profile window with the independent plain dense gridder (backend "jnp";
the column keeps the JAX script's name, `*_vs_xla`) and, since every
synthetic dataset is a forward NUFFT of the coil-weighted Shepp-Logan, also
scores against the phantom ground truth (context: shows the undersampling
level, not implementation error).

    python -m tron_tpu_torch.tools.dataset_metrics IMG.ra --data DATA.ra --nc 6 \
          [-G] [-u 0.4] [-d 21] [--csv out.csv] [--frames 0,400,-1] [--device cpu]
"""

import argparse
import csv
import os

import numpy as np

FIELDS = [
    "label", "frame", "ssim_vs_xla", "nmse_vs_xla",
    "ssim_vs_truth", "nmse_vs_truth", "oracle_nrmse", "oracle_ssim",
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("img")
    p.add_argument("--data", required=True, help="source acquisition .ra")
    p.add_argument("--nc", type=int, required=True, help="coils the fixture used")
    p.add_argument("-G", dest="golden", action="store_true")
    p.add_argument("-u", dest="undersamp", type=float, default=1.0)
    p.add_argument("-d", dest="slide", type=int, default=0)
    p.add_argument("--csv", default="output/dataset_metrics.csv")
    p.add_argument("--frames", default="0,-1", help="comma list; -1 = last")
    p.add_argument("--label", default=None)
    p.add_argument(
        "--oracle",
        action="store_true",
        help="also score each frame against the exact chunked DTFT adjoint "
        "at the full frame geometry (the truly independent anchor, playing "
        "IRT's role in src/RUNME4_others_grid_slcmt.m:283-312)",
    )
    p.add_argument("--device", default="0", help="CUDA device index, or 'cpu'")
    args = p.parse_args(argv)

    import torch

    from tron_tpu_torch.config import ReconConfig
    from tron_tpu_torch.device import resolve_device
    from tron_tpu_torch.io import ra_query, ra_read
    from tron_tpu_torch.io.native import ra_read_profiles
    from tron_tpu_torch.metrics import nmse, ssim
    from tron_tpu_torch.oracle import oracle_adjoint_recon
    from tron_tpu_torch.phantom import birdcage_sensitivities, shepp_logan
    from tron_tpu_torch.recon import reconstruct_frame
    from tron_tpu_torch.trajectory import spoke_angles

    dev = torch.device("cpu") if args.device == "cpu" else resolve_device(int(args.device))
    rec = ra_read(args.img)  # (1, nt, nx, ny, nz)
    nz = rec.shape[-1]
    n = rec.shape[2]

    cfg = ReconConfig(
        golden_angle=args.golden,
        data_undersamp=args.undersamp,
        prof_slide=args.slide,
        adjoint=True,
        backend="jnp",
    )
    hdr = ra_query(args.data)
    nro, npe1 = int(hdr.dims[2]), int(hdr.dims[3])
    work, slide, nz2 = cfg.frame_geometry(nro, npe1)
    assert nz2 == nz, (nz2, nz)

    truth = np.sqrt(
        np.sum(
            np.abs(shepp_logan(n)[None] * birdcage_sensitivities(n, args.nc)) ** 2,
            axis=0,
        )
    ).T

    def oracle(win, skip):
        """Exact adjoint recon of one (nc, work, nro) window -> SoS (n, n)."""
        ang = spoke_angles(work, cfg.scheme_for("adjoint"), skip, device=dev)
        img = oracle_adjoint_recon(win, ang, cfg, n, nro)
        return torch.sqrt(torch.sum(torch.abs(img) ** 2, dim=0))

    def scale_to(a, b):
        s = float(np.vdot(a, b).real / np.vdot(a, a).real)
        return s * a

    rows = []
    for f in (int(x) for x in args.frames.split(",")):
        z = f % nz
        frame = np.abs(rec[0, 0, :, :, z])
        pe0 = z * slide
        win = ra_read_profiles(args.data, pe0, work)[:, 0].transpose(0, 2, 1)
        win_d = torch.from_numpy(np.ascontiguousarray(win)).to(dev)
        # .ra x/y slots are transposed vs the recon's (y, x)
        ref = np.abs(reconstruct_frame(win_d, cfg.skip_angles + pe0, cfg).cpu().numpy()).T
        row = {
            "label": args.label or os.path.basename(args.img),
            "frame": z,
            "ssim_vs_xla": round(float(ssim(frame, ref)), 6),
            "nmse_vs_xla": round(float(nmse(frame, ref)), 7),
            "ssim_vs_truth": round(float(ssim(scale_to(frame, truth), truth)), 6),
            "nmse_vs_truth": round(float(nmse(scale_to(frame, truth), truth)), 6),
        }
        if args.oracle:
            orc = np.abs(oracle(win_d, cfg.skip_angles + pe0).cpu().numpy()).T
            row["oracle_nrmse"] = round(
                float(np.linalg.norm(frame - orc) / np.linalg.norm(orc)), 7
            )
            row["oracle_ssim"] = round(float(ssim(frame, orc)), 6)
        rows.append(row)

    # fixed schema regardless of --oracle (blank cells when not computed)
    # so appended runs never produce ragged rows under an older header
    write_header = True
    if os.path.exists(args.csv):
        with open(args.csv, newline="") as fh:
            head = fh.readline().strip()
        if head == ",".join(FIELDS):
            write_header = False
        else:
            # a pre-schema file: appending 8-cell rows under its header
            # would produce ragged rows, so move it aside and start afresh
            backup = args.csv + ".old"
            os.replace(args.csv, backup)
            print(f"note: {args.csv} had an older schema; moved to {backup}")
    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
    with open(args.csv, "a", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=FIELDS, extrasaction="ignore")
        if write_header:
            w.writeheader()
        for r in rows:
            w.writerow(r)
            print(r)
    return rows


if __name__ == "__main__":
    main()
