"""Command-line interface of the port, `tron-torch` (counterpart of
`tron_tpu/cli.py`), flag-compatible with `tron` for the 2-D recon:

    tron-torch [-a] [-G] [-u f] [-d slide] [-s skip] [-k w] [-o os] [-i n]
               [-g gpu] [-v] [--toeplitz] [--sdc ramlak|ideal]
               [--combine sos|none] [--half] [--incremental] in.ra [out.ra]

With `-a` the input is a 5-D .ra (nc, nt, nro, npe1, npe2) and the output
(1, nt, nx, ny, nz) with nx = nro/2; `-i n` runs n CGNR iterations per
frame (`--toeplitz` applies its normal operator as an FFT convolution).
Without `-a` (forward) the input is an image stack (nc, nt, nx, ny, nz) and
the output (nc, nt, nro, npe1, nz) with nro = gridos*nx and npe1 = u*nro,
as with `tron`.  `-g` picks the CUDA device.  Flags of `tron` that the port
does not run yet exit with status 2 and `error: <flag> is not ported yet`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.device import resolve_device
from tron_tpu_torch.io import ra_read, ra_write


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tron-torch",
        description="Trajectory-optimized Non-uniform Fast Fourier Transform "
        "(PyTorch/CUDA)",
    )
    # declared only to be refused: argparse would take a bare -3 for a
    # negative-number positional
    p.add_argument("-3", dest="koosh", action="store_true", help="3D stack-of-stars (not ported yet)")
    p.add_argument("-a", dest="adjoint", action="store_true", help="adjoint operation")
    p.add_argument("-d", dest="prof_slide", type=int, default=0, help="profiles to slide between frames")
    p.add_argument("-g", dest="device", type=int, default=0, help="CUDA device index")
    p.add_argument("-G", dest="golden_angle", action="store_true", help="golden angle radial")
    p.add_argument("-i", dest="niter", type=int, default=0, help="CGNR iterations")
    p.add_argument("-k", dest="kernwidth", type=float, default=2.0, help="gridding kernel width")
    p.add_argument("-o", dest="gridos", type=float, default=2.0, help="grid oversampling factor")
    p.add_argument("-s", dest="skip_angles", type=int, default=0, help="initial profiles to skip")
    p.add_argument("-u", dest="data_undersamp", type=float, default=1.0, help="data undersampling factor")
    p.add_argument("-v", dest="verbose", action="store_true", help="verbose output")
    p.add_argument("--sdc", default="ramlak", choices=["ramlak", "ideal"],
                   help="density compensation: reference Ram-Lak or exact polar cells")
    p.add_argument("--combine", default="sos", choices=["sos", "none", "walsh"],
                   help="coil combination (walsh is not ported yet)")
    p.add_argument("--half", action="store_true",
                   help="write float16 output (.ra eltype float/2, re/im on a leading dim of 2)")
    p.add_argument("--toeplitz", action="store_true",
                   help="with -i: apply the CGNR normal operator as a "
                   "Toeplitz-embedded FFT convolution (one PSF kernel per frame)")
    p.add_argument("--incremental", action="store_true",
                   help="telescoping sliding-window gridding (golden-angle "
                   "overlapping windows; other cases use the direct path)")
    p.add_argument("infile")
    p.add_argument("outfile", nargs="?", default="img_tron.ra")
    return p


def _not_ported(what: str) -> int:
    print(f"error: {what} is not ported yet", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    flags = [a for a in unknown if a.startswith("-")]
    if flags:
        return _not_ported(flags[0])
    if args.koosh:
        return _not_ported("-3")
    if unknown:
        print(f"error: unrecognized arguments: {' '.join(unknown)}", file=sys.stderr)
        return 2
    if args.combine == "walsh":
        return _not_ported("--combine walsh")

    def vprint(*a):
        if args.verbose:
            print(*a, file=sys.stderr)

    cfg = ReconConfig(
        gridos=args.gridos,
        kernwidth=args.kernwidth,
        golden_angle=args.golden_angle,
        skip_angles=args.skip_angles,
        data_undersamp=args.data_undersamp,
        prof_slide=args.prof_slide,
        adjoint=args.adjoint,
        niter=args.niter,
        toeplitz=args.toeplitz,
        incremental=args.incremental,
        sdc=args.sdc,
        coil_combine=args.combine,
    )
    if args.incremental and (not cfg.golden_angle or cfg.niter > 0):
        why = "CGNR (-i)" if cfg.niter > 0 else "non-golden-angle scheme"
        print(f"note: --incremental ignored ({why} uses the direct path)")

    vprint(f"Reading {args.infile}")
    try:
        indata = ra_read(args.infile)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not np.iscomplexobj(indata):
        # a leading dim of 2 is the re/im-pair convention of the MATLAB
        # raread/rawrite twins (src/raread.m:25-57); anything else is promoted
        if indata.ndim == 6 and indata.shape[0] == 2:
            indata = (
                indata[0].astype(np.float32) + 1j * indata[1].astype(np.float32)
            ).astype(np.complex64)
        else:
            indata = indata.astype(np.complex64)
    if indata.ndim != 5:
        print(f"error: expected 5-D .ra input, got {indata.ndim}-D", file=sys.stderr)
        return 1
    vprint(f"indims = {indata.shape}")

    from tron_tpu_torch.recon import recon_radial2d

    device = resolve_device(args.device)
    start = time.perf_counter()
    out = recon_radial2d(indata, cfg, half_readback=args.half and cfg.adjoint, device=device)
    vprint(f"Elapsed time: {time.perf_counter() - start:.2f} s")

    if not cfg.adjoint:
        # out: (nz, nc, nt, npe1, nro) -> .ra dims (nc, nt, nro, npe1, npe2=nz)
        arr = np.transpose(out, (1, 2, 4, 3, 0))
    elif out.ndim == 5:
        # --combine none keeps the coil axis: (nz, nt, nc, ny, nx)
        # -> .ra dims (nc, nt, nx, ny, nz)
        arr = np.transpose(out, (2, 1, 4, 3, 0))
    else:
        # out: (nz, nt, ny, nx) -> .ra dims (1, nt, nx, ny, nz)
        arr = np.transpose(out[None], (0, 2, 4, 3, 1))
    if args.half:
        arr = np.stack([arr.real, arr.imag]).astype(np.float16)
    else:
        arr = arr.astype(np.complex64)
    ra_write(arr, args.outfile)
    vprint(f"Saved result to {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
