"""Command-line interface of the port, `tron-torch` (counterpart of
`tron_tpu/cli.py`), flag-compatible with `tron` and the reference binary:

    tron-torch [-3aGv] [-i n] [-k w] [-o os] [-u f] [-d slide] [-s skip]
               [-B blocks] [-T threads] [-r nro] [-g gpu]
               [--scheme linear_half|linear_full] [--sdc ramlak|ideal]
               [--combine sos|walsh|none] [--compress N] [--half]
               [--toeplitz] [--incremental] [--stream]
               [--backend auto|jnp|pallas] [--precision fast|accurate]
               [--profile DIR] in.ra [out.ra]

With `-a` the input is a 5-D .ra (nc, nt, nro, npe1, npe2) and the output
(1, nt, nx, ny, nz) with nx = nro/2; `-i n` runs n CGNR iterations per
frame (`--toeplitz` applies its normal operator as an FFT convolution).
Without `-a` (forward) the input is an image stack (nc, nt, nx, ny, nz) and
the output (nc, nt, nro, npe1, nz) with nro = gridos*nx and npe1 = u*nro,
as with `tron`.  `-3` treats the last axis as the kz phase encoding of a
stack of stars: the adjoint writes nz = npe2 * (in-plane frames) images,
slice-major.  `--stream` (adjoint) reads profile windows from disk block by
block and lands each block of images in its region of the output file; with
`-3` it streams npe1 windows at all kz encodings.  `--compress N` projects
the coils onto N virtual coils (ignored with `-3`).  `-g` picks the CUDA
device; `-B`, `-T` and `-r` are accepted and ignored, as `tron` does.

Exit status 2, with one line naming the reason: `--shard`, `--shard-spokes`
(multi-GPU, not ported yet), `--dft-dot` (the port has no MXU DFT) and
`-k` outside 0 < w < 7 (the kernels' weight windows).
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
    p.add_argument("-3", dest="koosh", action="store_true", help="3D stack-of-stars")
    p.add_argument("-a", dest="adjoint", action="store_true", help="adjoint operation")
    p.add_argument("-B", dest="blocks", type=int, default=4096, help="(ignored; reference compat)")
    p.add_argument("-d", dest="prof_slide", type=int, default=0, help="profiles to slide between frames")
    p.add_argument("-g", dest="device", type=int, default=0, help="CUDA device index")
    p.add_argument("-G", dest="golden_angle", action="store_true", help="golden angle radial")
    p.add_argument("-i", dest="niter", type=int, default=0, help="CGNR iterations")
    p.add_argument("-k", dest="kernwidth", type=float, default=2.0, help="gridding kernel width")
    p.add_argument("-o", dest="gridos", type=float, default=2.0, help="grid oversampling factor")
    p.add_argument("-r", dest="nro", type=int, default=0, help="(unused, like the reference)")
    p.add_argument("-s", dest="skip_angles", type=int, default=0, help="initial profiles to skip")
    p.add_argument("-T", dest="threads", type=int, default=128, help="(ignored; reference compat)")
    p.add_argument("-u", dest="data_undersamp", type=float, default=1.0, help="data undersampling factor")
    p.add_argument("-v", dest="verbose", action="store_true", help="verbose output")
    p.add_argument("--backend", default="auto", choices=["auto", "jnp", "pallas"],
                   help="gridder and degridder: pallas = the CUDA kernels (raises on a "
                   "CPU tensor), jnp = their plain torch versions on any device, auto = "
                   "the kernels on the card")
    p.add_argument("--scheme", default=None, choices=["linear_half", "linear_full"],
                   help="linear-angle convention override; the reference uses linear_half "
                   "for degrid and linear_full for grid (src/tron.cu:509 vs :555), so a "
                   "self-consistent degrid->grid roundtrip needs an explicit scheme")
    p.add_argument("--sdc", default="ramlak", choices=["ramlak", "ideal"],
                   help="density compensation: reference Ram-Lak or exact polar cells")
    p.add_argument("--combine", default="sos", choices=["sos", "walsh", "none"],
                   help="coil combination (adjoint only)")
    p.add_argument("--half", action="store_true",
                   help="write float16 output (.ra eltype float/2, re/im on a leading dim of 2)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the recon into DIR")
    p.add_argument("--precision", default="fast", choices=["fast", "accurate"],
                   help="precision class of the gridder as `tron` names it (fast = "
                   "bfloat16, accurate = bf16x3); the CUDA kernels compute every class "
                   "to float32 grade, so both give the same images")
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
                   "straight into its region of the output file).  With -3, "
                   "streams npe1 profile windows at all kz encodings")
    p.add_argument("--compress", type=int, default=0, metavar="N",
                   help="SVD-compress to N virtual coils before gridding (with "
                   "--stream: one disk pass for the basis, projected on the host "
                   "per block)")
    p.add_argument("infile")
    p.add_argument("outfile", nargs="?", default="img_tron.ra")
    return p


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


def _run_streamed(args, base_dims, prep, recon_call) -> int:
    """What the two --stream paths share (counterpart of
    `tron_tpu/cli.py:185-215`): open the output .ra for region writes
    (``io.RaWriter``), hand the recon a writer that lands each block at
    its frame offset in on-disk element order, turn an input ValueError into
    exit 1, and remove the partial file on any failure.

    ``prep(blk)`` runs on the host per block before the layout transpose (the
    -3 path's --half pair cast); ``recon_call(writer)`` runs the streamed
    recon."""
    from tron_tpu_torch.io import RaWriter

    dims = (2, *base_dims) if args.half else base_dims
    frame_elems = int(np.prod(dims[:-1]))
    w = RaWriter(args.outfile, dims, np.float16 if args.half else np.complex64)

    def writer(z0, blk):
        w.write_at(z0 * frame_elems, _block_to_disk_order(prep(blk), args.half))

    try:
        recon_call(writer)
    except ValueError as e:
        w.abort()
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BaseException:
        w.abort()
        raise
    w.close()
    return 0


def _stream_to_file(args, cfg: ReconConfig, hdr, device) -> int:
    """--stream: each block of images lands in its region of the output .ra
    while the card computes the next block; peak host memory is a few
    blocks, not the whole series (counterpart of `tron_tpu/cli.py:218-241`)."""
    from tron_tpu_torch.io.native import radial_dims
    from tron_tpu_torch.recon import recon_radial2d_streaming

    nc, nt, nro, npe1, _npe2, _pair = radial_dims(hdr)
    _, _, nz = cfg.frame_geometry(nro, npe1)
    n = nro // 2
    nc_out = 1
    if cfg.coil_combine == "none":
        nc_out = cfg.coil_compress if 0 < cfg.coil_compress < nc else nc
    return _run_streamed(
        args,
        (nc_out, nt, n, n, nz),
        lambda blk: blk,
        lambda writer: recon_radial2d_streaming(
            args.infile, cfg, writer=writer, half=args.half, device=device
        ),
    )


def _stream_koosh_to_file(args, cfg: ReconConfig, hdr, device) -> int:
    """-3 --stream: the streamed stack-of-stars adjoint, blocked over npe1.
    Each block handed to the writer is a contiguous run of output frames of
    one kz slice (slice-major, as the in-memory -3 output), so it lands as
    one region (counterpart of `tron_tpu/cli.py:244-278`)."""
    import dataclasses

    from tron_tpu_torch.io.native import radial_dims
    from tron_tpu_torch.recon import recon_koosh_streaming

    nc, nt, nro, npe1, npe2, _pair = radial_dims(hdr)
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    _, _, nzi = cfg2.frame_geometry(nro, npe1)
    n = nro // 2
    # no coil_compress branch: the stack-of-stars recons take all physical
    # coils (main() prints a note when -3 --compress is given)
    nc_out = nc if cfg.coil_combine == "none" else 1

    def prep(blk):
        # (bf, nt, [nc,] ny, nx) complex64 -> the float16 pair convention when
        # --half (exact: the readback from the card already rounded to f16)
        if args.half:
            blk = np.stack([blk.real, blk.imag]).astype(np.float16)
        return blk

    return _run_streamed(
        args,
        (nc_out, nt, n, n, npe2 * nzi),
        prep,
        lambda writer: recon_koosh_streaming(
            args.infile, cfg, writer=writer, half=args.half, device=device
        ),
    )


# flags of `tron` that the port does not run, each with its reason
_REFUSED = {
    "--shard": "multi-GPU frame sharding is not ported yet (ROADMAP A17)",
    "--shard-spokes": "multi-GPU spoke sharding is not ported yet (ROADMAP A17)",
    "--dft-dot": "not ported: the port has no MXU DFT, its FFTs go through torch.fft",
}


def _profiler(profile_dir, device):
    """--profile DIR: a torch.profiler context whose Chrome trace lands in
    DIR when the recon ends (CPU activity only when there is no card)."""
    import contextlib
    import os

    if not profile_dir:
        return contextlib.nullcontext()
    import torch

    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=lambda prof: prof.export_chrome_trace(
            os.path.join(profile_dir, f"tron_torch_{os.getpid()}.trace.json")
        ),
    )


def main(argv=None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    for a in unknown:
        if a.startswith("-"):
            flag = a.split("=", 1)[0]
            why = _REFUSED.get(flag)
            if why is None:
                print(f"error: unrecognized arguments: {a}", file=sys.stderr)
            else:
                print(f"error: {flag}: {why}", file=sys.stderr)
            return 2
    if unknown:
        print(f"error: unrecognized arguments: {' '.join(unknown)}", file=sys.stderr)
        return 2

    from tron_tpu_torch.ops.grid_cuda import MAX_KERNWIDTH

    if not 0 < args.kernwidth < MAX_KERNWIDTH:
        # before any data is read, on the card and on the CPU alike
        print(f"error: -k {args.kernwidth:g}: the gridding and degridding kernels take "
              f"0 < kernwidth < {MAX_KERNWIDTH:g}", file=sys.stderr)
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
        koosh=args.koosh,
        incremental=args.incremental,
        backend=args.backend,
        angle_scheme=args.scheme,
        sdc=args.sdc,
        coil_combine=args.combine,
        coil_compress=args.compress,
        matmul_dtype="bf16x3" if args.precision == "accurate" else "bfloat16",
    )
    if args.incremental and (not cfg.golden_angle or cfg.niter > 0):
        why = "CGNR (-i)" if cfg.niter > 0 else "non-golden-angle scheme"
        print(f"note: --incremental ignored ({why} uses the direct path)")
    # -3 --stream has its own recon, blocked over npe1 (kz cannot stream:
    # its inverse FFT mixes every npe2 encoding of a sample)
    koosh_stream = args.stream and cfg.adjoint and cfg.koosh
    stream = args.stream and cfg.adjoint and not cfg.koosh
    if args.stream and not stream and not koosh_stream:
        print("note: --stream ignored (forward mode loads the input in memory)")
    if cfg.koosh and cfg.coil_compress:
        # neither stack-of-stars recon compresses coils: say so instead of
        # silently writing nc uncompressed coils
        print("note: --compress ignored (-3 recons all physical coils)")

    if stream or koosh_stream:
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
        with _profiler(args.profile, device):
            if koosh_stream:
                rc = _stream_koosh_to_file(args, cfg, hdr, device)
            else:
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
    with _profiler(args.profile, device):
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
