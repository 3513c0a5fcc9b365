"""Cross-implementation comparison harness (counterpart of
`scripts/compare_recon.py`, itself the rebuild of the reference's
RUNME2/RUNME4-7 MATLAB scripts): reconstruct the same dataset with several
methods, report NMSE/RMSE/SSIM tables, persist CSV and figures.

    python -m tron_tpu_torch.tools.compare_recon [--n 64] [--npe 128] [--out output/torch/]

Methods compared:
  * tron-jnp     the plain torch dense gridder (backend "jnp")
  * tron-pallas  the CUDA gridding kernel (backend "pallas"; needs the card,
                 so it is left out with `--device cpu` or `--skip-pallas`)
  * oracle       exact weighted adjoint DTFT (the accuracy gold standard,
                 playing IRT's role)

All methods run in this process on one device (`--device N`, or `--device
cpu`); the method names and the CSV columns are those of the JAX script.
On the card, times are host wall clock around a synchronised second call.
Figures are drawn where matplotlib is installed, and left out (with a
printed note) where it is not, as on the card's machine.
"""

import argparse
import csv
import importlib.util
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--npe", type=int, default=128)
    p.add_argument("--golden", action="store_true")
    p.add_argument("--out", default="output/torch")
    p.add_argument("--skip-oracle", action="store_true")
    p.add_argument("--skip-pallas", action="store_true")
    p.add_argument("--device", default="0", help="CUDA device index, or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from tron_tpu_torch.config import AngleScheme, ReconConfig
    from tron_tpu_torch.device import parse_device
    from tron_tpu_torch.metrics import nmse, nrmse, ssim
    from tron_tpu_torch.nufft import nufft_adjoint, nufft_forward
    from tron_tpu_torch.oracle import oracle_adjoint_recon
    from tron_tpu_torch.phantom import shepp_logan
    from tron_tpu_torch.trajectory import spoke_angles
    from tron_tpu_torch.viz import compare as viz_compare
    from tron_tpu_torch.viz import mosaic

    dev = parse_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    n, npe = args.n, args.npe
    scheme = AngleScheme.GOLDEN if args.golden else AngleScheme.LINEAR_HALF
    base = dict(angle_scheme=None if args.golden else scheme, golden_angle=args.golden)

    img = shepp_logan(n)
    angles = spoke_angles(npe, scheme, 0, device=dev)
    cfg0 = ReconConfig(**base)
    nro = int(cfg0.gridos * n)
    data = nufft_forward(torch.from_numpy(img.astype(np.complex64)).to(dev), angles, cfg0, nro=nro)

    def timed(fn):
        """Second call of ``fn`` (the first builds and warms), synchronised."""
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = fn().cpu().numpy()
        return r, time.perf_counter() - t0

    recons, times = {}, {}
    cfg = ReconConfig(backend="jnp", **base)
    recons["tron-jnp"], times["tron-jnp"] = timed(lambda: nufft_adjoint(data, angles, cfg))

    if not args.skip_pallas:
        if dev.type == "cuda":
            cfgk = ReconConfig(backend="pallas", **base)
            recons["tron-pallas"], times["tron-pallas"] = timed(
                lambda: nufft_adjoint(data, angles, cfgk))
            print(f"# tron-pallas ran on: {torch.cuda.get_device_name(dev)}")
        else:
            print("# tron-pallas: skipped (the CUDA kernel needs the card; --device cpu)")

    if not args.skip_oracle and n <= 512:
        t0 = time.perf_counter()
        recons["oracle"] = oracle_adjoint_recon(data, angles, cfg0, n, nro).cpu().numpy()
        times["oracle"] = time.perf_counter() - t0

    ref = recons.get("oracle", recons.get("tron-jnp"))
    rows = []
    for name, r in recons.items():
        rows.append(
            {
                "method": name,
                "time_s": round(times[name], 4),
                "nmse_vs_ref": round(nmse(r, ref), 8),
                "nrmse_vs_ref": round(nrmse(r, ref), 8),
                "ssim_vs_ref": round(ssim(np.abs(r), np.abs(ref)), 6),
                "nrmse_vs_truth": round(nrmse(np.abs(r) / np.abs(r).max(),
                                              np.abs(img) / max(np.abs(img).max(), 1e-9)), 6),
            }
        )
        print(rows[-1])

    csv_path = os.path.join(args.out, f"compare_n{n}_npe{npe}.csv")
    with open(csv_path, "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=rows[0].keys())
        wtr.writeheader()
        wtr.writerows(rows)
    print(f"# wrote {csv_path}")

    if importlib.util.find_spec("matplotlib") is None:
        print("# figures left out: matplotlib is not installed")
        return rows
    names = list(recons)
    mosaic(
        np.stack([np.abs(recons[k]) for k in names]),
        os.path.join(args.out, f"recons_n{n}.png"),
        title=" | ".join(names),
    )
    if len(names) >= 2:
        viz_compare(
            recons[names[0]], recons[names[-1]],
            os.path.join(args.out, f"diff_{names[0]}_vs_{names[-1]}.png"),
            labels=(names[0], names[-1]),
        )
    print("# figures written to", args.out)
    return rows


if __name__ == "__main__":
    main()
