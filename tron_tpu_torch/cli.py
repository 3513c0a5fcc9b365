"""Command-line interface of the port, `tron-torch` (counterpart of
`tron_tpu/cli.py`), flag-compatible with `tron` for the 2-D recon:

    tron-torch [-a] [-G] [-u f] [-d slide] [-s skip] [-k w] [-o os] [-i n]
               [-g gpu] [-v] [--toeplitz] [--sdc ramlak|ideal]
               [--combine sos|none] [--half] [--incremental]
               [--stream [--compress N]] in.ra [out.ra]

With `-a` the input is a 5-D .ra (nc, nt, nro, npe1, npe2) and the output
(1, nt, nx, ny, nz) with nx = nro/2; `-i n` runs n CGNR iterations per
frame (`--toeplitz` applies its normal operator as an FFT convolution).
Without `-a` (forward) the input is an image stack (nc, nt, nx, ny, nz) and
the output (nc, nt, nro, npe1, nz) with nro = gridos*nx and npe1 = u*nro,
as with `tron`.  `--stream` (adjoint) reads profile windows from disk block
by block and lands each block of images in its region of the output file;
`--compress N` (with `--stream`) projects the coils onto N virtual coils.
`-g` picks the CUDA device.  Flags of `tron` that the port does not run
yet exit with status 2 and `error: <flag> is not ported yet`.
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
    p.add_argument("--stream", action="store_true",
                   help="stream profile windows from disk instead of loading "
                   "the whole acquisition (adjoint recon, any nt, complex/"
                   "float/fp16-pair inputs; each block of images is written "
                   "straight into its region of the output file)")
    p.add_argument("--compress", type=int, default=0, metavar="N",
                   help="with --stream: SVD-compress to N virtual coils (one "
                   "disk pass for the basis, projected on the host per block)")
    p.add_argument("infile")
    p.add_argument("outfile", nargs="?", default="img_tron.ra")
    return p


def _not_ported(what: str) -> int:
    print(f"error: {what} is not ported yet", file=sys.stderr)
    return 2


def _block_to_disk_order(blk: np.ndarray, half: bool) -> np.ndarray:
    """One streamed block of frame images in on-disk .ra element order
    (dims[0] fastest: [pair-of-2,] coil, t, x, y, frame), the bytes of the
    in-memory output transposes at the end of main().

    blk: (bf, nt, [nc,] ny, nx) complex64, or (2, bf, nt, [nc,] ny, nx)
    float16 re/im planes when ``half``."""
    if half:
        if blk.ndim == 5:        # (2, bf, nt, ny, nx) -> (bf, y, x, t, 2)
            return np.ascontiguousarray(blk.transpose(1, 3, 4, 2, 0))
        # (2, bf, nt, nc, ny, nx) -> (bf, y, x, t, c, 2)
        return np.ascontiguousarray(blk.transpose(1, 4, 5, 2, 3, 0))
    if blk.ndim == 4:            # (bf, nt, ny, nx) -> (bf, y, x, t)
        return np.ascontiguousarray(blk.transpose(0, 2, 3, 1))
    # (bf, nt, nc, ny, nx) -> (bf, y, x, t, c)
    return np.ascontiguousarray(blk.transpose(0, 3, 4, 1, 2))


def _stream_to_file(args, cfg: ReconConfig, hdr, device) -> int:
    """--stream: each block of images lands in its region of the output .ra
    (``io.RaWriter``) while the card computes the next block; peak host
    memory is a few blocks, not the whole series (counterpart of
    `tron_tpu/cli.py:185-241`).  Input errors exit 1; any failure removes
    the partial file."""
    from tron_tpu_torch.io import RaWriter
    from tron_tpu_torch.io.native import radial_dims
    from tron_tpu_torch.recon import recon_radial2d_streaming

    nc, nt, nro, npe1, _npe2, _pair = radial_dims(hdr)
    _, _, nz = cfg.frame_geometry(nro, npe1)
    n = nro // 2
    nc_out = 1
    if cfg.coil_combine == "none":
        nc_out = cfg.coil_compress if 0 < cfg.coil_compress < nc else nc
    dims = (nc_out, nt, n, n, nz)
    if args.half:
        dims = (2, *dims)
    frame_elems = int(np.prod(dims[:-1]))
    w = RaWriter(args.outfile, dims, np.float16 if args.half else np.complex64)

    def writer(z0, blk):
        w.write_at(z0 * frame_elems, _block_to_disk_order(blk, args.half))

    try:
        recon_radial2d_streaming(args.infile, cfg, writer=writer, half=args.half, device=device)
    except ValueError as e:
        w.abort()
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BaseException:
        w.abort()
        raise
    w.close()
    return 0


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
    stream = args.stream and args.adjoint
    if args.compress and not stream:
        print("error: --compress without --stream is not ported yet (ROADMAP A16)",
              file=sys.stderr)
        return 2

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
        coil_compress=args.compress,
    )
    if args.incremental and (not cfg.golden_angle or cfg.niter > 0):
        why = "CGNR (-i)" if cfg.niter > 0 else "non-golden-angle scheme"
        print(f"note: --incremental ignored ({why} uses the direct path)")
    if args.stream and not stream:
        print("note: --stream ignored (forward mode loads the input in memory)")

    if stream:
        # only the header is read here; profile windows are read block by
        # block inside the recon driver
        from tron_tpu_torch.io import ra_query
        from tron_tpu_torch.io.native import radial_dims

        vprint(f"Querying {args.infile} (streaming)")
        try:
            hdr = ra_query(args.infile)
            # a 6-D re/im-pair file counts as 5-D, as on the in-memory path
            ndim = len(hdr.dims) - (1 if radial_dims(hdr)[5] else 0)
        except (FileNotFoundError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if ndim != 5:
            print(f"error: expected 5-D .ra input, got {ndim}-D", file=sys.stderr)
            return 1
        vprint(f"indims = {tuple(int(x) for x in hdr.dims)}")
        device = resolve_device(args.device)
        start = time.perf_counter()
        rc = _stream_to_file(args, cfg, hdr, device)
        vprint(f"Elapsed time: {time.perf_counter() - start:.2f} s")
        if rc == 0:
            vprint(f"Saved result to {args.outfile}")
        return rc

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
