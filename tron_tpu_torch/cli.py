"""Command-line interface of the port, `tron-torch` (counterpart of
`tron_tpu/cli.py`), flag-compatible with `tron` and the reference binary:

    tron-torch [-3aGv] [-i n] [-k w] [-o os] [-u f] [-d slide] [-s skip]
               [-B blocks] [-T threads] [-r nro] [-g gpu]
               [--scheme linear_half|linear_full] [--sdc ramlak|ideal]
               [--combine sos|walsh|none] [--compress N] [--half]
               [--toeplitz] [--incremental] [--stream] [--shard | --shard-spokes]
               [--backend auto|jnp|pallas] [--precision fast|accurate]
               [--dft-dot auto|highest|bf16x3] [--profile DIR] in.ra [out.ra]

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
device; `-B`, `-T` and `-r` are accepted and ignored, as `tron` does, and
so is `--dft-dot` (off the TPU `tron` ignores it too: the port's FFTs are
`torch.fft` at fp32 for every precision class).

`--shard` splits the frames (with `-3` the kz slices, without `-a` the image
slices) over one process per CUDA device, `--shard-spokes` each frame's
spokes (`tron_tpu_torch/parallel/`).  Under `torchrun` (RANK, WORLD_SIZE and
LOCAL_RANK set) the program joins that world, every rank reads the input and
rank 0 writes the output; otherwise it starts one rank per visible card
itself, and with one card it runs in this process, on the card `-g` names.

Exit status 2, with one line naming the reason: `-k` outside 0 < w < 7
(the kernels' weight windows).
"""

from __future__ import annotations

import argparse
import os
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
                   help="precision class of the kernels on the card as `tron` names it "
                   "(fast = 1-pass bfloat16, accurate = compensated bf16x3, ~fp32); "
                   "on the CPU the plain operators run float32, as `tron`'s do")
    p.add_argument("--dft-dot", default="auto", choices=["auto", "highest", "bf16x3"],
                   help="(ignored; `tron`'s MXU DFT dot algorithm: the port's FFTs are "
                   "torch.fft at fp32)")
    p.add_argument("--toeplitz", action="store_true",
                   help="with -i: apply the CGNR normal operator as a "
                   "Toeplitz-embedded FFT convolution (one PSF kernel per frame)")
    p.add_argument("--incremental", action="store_true",
                   help="telescoping sliding-window gridding (golden-angle "
                   "overlapping windows; other cases use the direct path)")
    p.add_argument("--shard", action="store_true",
                   help="shard frames (-3: kz slices; forward: image slices) across "
                   "one process per CUDA device")
    p.add_argument("--shard-spokes", action="store_true",
                   help="shard each frame's spokes across one process per CUDA device "
                   "(adjoint 2D recon; the latency-parallel single-frame mode: partial "
                   "grids are summed over a 'spoke' mesh axis)")
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


def _recon_sharded_cli(indata, cfg: ReconConfig, mesh) -> np.ndarray:
    """--shard: the frame-sharded adjoint recon over the mesh (counterpart of
    `tron_tpu/cli.py:107-128`).  Repetitions loop on the host; every coil
    combine runs ('none' keeps the coil axis, as on the unsharded path)."""
    import torch

    from tron_tpu_torch.parallel import recon_frames_sharded

    nc, nt, nro, npe1 = indata.shape[:4]
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    d4 = indata.reshape(nc, nt, nro, npe1, -1)[..., 0]
    outs = []
    for t in range(nt):
        d = np.ascontiguousarray(np.transpose(d4[:, t], (0, 2, 1)), dtype=np.complex64)
        out = recon_frames_sharded(torch.from_numpy(d).to(mesh.device), cfg, mesh, work, slide, nz)
        outs.append(out.cpu().numpy())
    return np.stack(outs, axis=1)  # (nz, nt, [nc,] n, n)


def _recon_spoke_sharded_cli(indata, cfg: ReconConfig, mesh) -> np.ndarray:
    """--shard-spokes: every frame's profiles split over the mesh
    (`parallel/spoke.py`), the latency-parallel mode for frames that must
    come out one at a time (counterpart of `tron_tpu/cli.py:131-162`).
    Frames and repetitions loop on the host."""
    import torch

    from tron_tpu_torch.parallel import recon_window_spoke_sharded

    nc, nt, nro, npe1 = indata.shape[:4]
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    d4 = indata.reshape(nc, nt, nro, npe1, -1)[..., 0]
    outs = []
    for t in range(nt):
        d = torch.from_numpy(
            np.ascontiguousarray(np.transpose(d4[:, t], (0, 2, 1)), dtype=np.complex64)
        ).to(mesh.device)
        frames = [
            recon_window_spoke_sharded(d[:, z * slide : z * slide + work], cfg, mesh, skip=z * slide)
            for z in range(nz)
        ]
        outs.append(torch.stack(frames).cpu().numpy())  # (nz, [nc,] n, n)
    return np.stack(outs, axis=1)  # (nz, nt, [nc,] n, n)


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


def _stream_to_file(args, cfg: ReconConfig, hdr, device, mesh=None, root: bool = True) -> int:
    """--stream: each block of images lands in its region of the output .ra
    while the card computes the next block; peak host memory is a few
    blocks, not the whole series (counterpart of `tron_tpu/cli.py:218-241`).
    With ``mesh`` (--stream --shard) every rank runs the streamed recon and
    the ``root`` rank alone opens and writes the output."""
    from tron_tpu_torch.io.native import radial_dims
    from tron_tpu_torch.recon import recon_radial2d_streaming

    nc, nt, nro, npe1, _npe2, _pair = radial_dims(hdr)
    _, _, nz = cfg.frame_geometry(nro, npe1)
    n = nro // 2
    nc_out = 1
    if cfg.coil_combine == "none":
        nc_out = cfg.coil_compress if 0 < cfg.coil_compress < nc else nc
    def recon_call(writer):
        recon_radial2d_streaming(
            args.infile, cfg, mesh=mesh, writer=writer, half=args.half, device=device
        )

    if not root:
        recon_call(lambda z0, blk: None)
        return 0
    return _run_streamed(args, (nc_out, nt, n, n, nz), lambda blk: blk, recon_call)


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


# s; a sharded run started here that takes longer is stopped
RANKS_TIMEOUT_S = 24 * 3600.0


def rank_main(ctx, argv: list) -> int:
    """One rank of a sharded run started by main() (`parallel/launch.py`)."""
    return main(argv, _rank=ctx)


def main(argv=None, _rank=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"error: unrecognized arguments: {' '.join(unknown)}", file=sys.stderr)
        return 2

    from tron_tpu_torch.ops.grid_cuda import MAX_KERNWIDTH

    if not 0 < args.kernwidth < MAX_KERNWIDTH:
        # before any data is read, on the card and on the CPU alike
        print(f"error: -k {args.kernwidth:g}: the gridding and degridding kernels take "
              f"0 < kernwidth < {MAX_KERNWIDTH:g}", file=sys.stderr)
        return 2

    # -- which rank of how many this process is ------------------------------
    sharded = args.shard or args.shard_spokes
    rank, world, device = 0, 1, None
    if _rank is not None:
        rank, world, device = _rank.rank, _rank.world, _rank.device
    elif sharded and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # under torchrun: join its world, run, leave
        from tron_tpu_torch.parallel import distributed

        distributed.initialize()
        try:
            return _run(
                args, distributed.rank(), distributed.world_size(), distributed.default_device()
            )
        finally:
            distributed.shutdown()
    elif sharded:
        import torch

        cards = torch.cuda.device_count()
        if cards > 1:
            from tron_tpu_torch.parallel import launch

            results = launch.start_ranks(
                "tron_tpu_torch.cli:rank_main", cards, {"argv": argv}, timeout=RANKS_TIMEOUT_S
            )
            return max(r.value for r in results)
    return _run(args, rank, world, device)


def _run(args, rank: int, world: int, device) -> int:
    """The run of one rank of ``world`` on ``device`` (None: the card `-g`
    names).  Rank 0 prints and writes the output."""
    root = rank == 0

    def vprint(*a):
        if args.verbose and root:
            print(*a, file=sys.stderr)

    def note(msg):
        if root:
            print(f"note: {msg}")

    def fail(msg) -> int:
        if root:
            print(f"error: {msg}", file=sys.stderr)
        return 1

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
    # --shard honours --incremental (each frame shard telescopes from its own
    # first frame, `parallel/mesh.py`), so no note for it
    vprint(f"note: --dft-dot {args.dft_dot} ignored (the FFTs are torch.fft at fp32 for every "
           "precision class)")
    if args.incremental and (args.shard_spokes or not cfg.golden_angle or cfg.niter > 0):
        why = (
            "spoke-sharded recon" if args.shard_spokes
            else "CGNR (-i)" if cfg.niter > 0
            else "non-golden-angle scheme"
        )
        note(f"--incremental ignored ({why} uses the direct path)")
    # --stream composes with --shard (each disk block's frames go through the
    # sharded scheduler); --shard-spokes stays in memory.  -3 --stream has
    # its own recon, blocked over npe1 (kz cannot stream: its inverse FFT
    # mixes every npe2 encoding of a sample)
    koosh_stream = (
        args.stream and cfg.adjoint and cfg.koosh and not args.shard and not args.shard_spokes
    )
    stream = args.stream and cfg.adjoint and not cfg.koosh and not args.shard_spokes
    if args.stream and not stream and not koosh_stream:
        why = (
            "--shard-spokes" if args.shard_spokes
            else "forward mode" if not cfg.adjoint
            else "-3 --shard"
        )
        note(f"--stream ignored ({why} loads the input in memory)")
    if cfg.koosh and cfg.coil_compress:
        # neither stack-of-stars recon compresses coils: say so instead of
        # silently writing nc uncompressed coils
        note("--compress ignored (-3 recons all physical coils)")
    elif cfg.coil_compress and (args.shard_spokes or (args.shard and not stream)):
        # as `tron`, whose in-memory sharded recons take the physical coils;
        # here it is said
        note("--compress ignored (the in-memory sharded recons take all physical coils)")

    def frame_mesh():
        from tron_tpu_torch.parallel import make_mesh

        return make_mesh(n_frame=world, n_coil=1, device=device)

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
            return fail(e)
        if ndim != 5:
            return fail(f"expected 5-D .ra input, got {ndim}-D")
        vprint(f"indims = {tuple(int(x) for x in hdr.dims)}")
        if device is None:
            device = resolve_device(args.device)
        start = time.perf_counter()
        with _profiler(args.profile, device):
            if koosh_stream:
                rc = _stream_koosh_to_file(args, cfg, hdr, device)
            else:
                rc = _stream_to_file(
                    args, cfg, hdr, device, frame_mesh() if args.shard else None, root
                )
        vprint(f"Elapsed time: {time.perf_counter() - start:.2f} s")
        if rc == 0:
            vprint(f"Saved result to {args.outfile}")
        return rc

    vprint(f"Reading {args.infile}")
    try:
        indata = ra_read(args.infile)
    except (FileNotFoundError, ValueError) as e:
        return fail(e)
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
        return fail(f"expected 5-D .ra input, got {indata.ndim}-D")
    vprint(f"indims = {indata.shape}")

    from tron_tpu_torch.recon import recon_radial2d

    if device is None:
        device = resolve_device(args.device)
    start = time.perf_counter()
    with _profiler(args.profile, device):
        if args.shard and cfg.adjoint and not cfg.koosh:
            out = _recon_sharded_cli(indata, cfg, frame_mesh())
        elif args.shard and cfg.adjoint:
            # -3 --shard: after the kz inverse FFT the slices are as
            # independent as frames, and shard over 'frame' like them
            from tron_tpu_torch.parallel import recon_stack_of_stars_sharded

            out = recon_stack_of_stars_sharded(indata, cfg, frame_mesh())
        elif args.shard:
            # forward --shard: image slices degrid independently; -3 adds
            # one gather before the kz FFT
            from tron_tpu_torch.parallel import recon_forward_sharded

            out = recon_forward_sharded(indata, cfg, frame_mesh())
        elif args.shard_spokes and cfg.adjoint and not cfg.koosh:
            from tron_tpu_torch.parallel import make_spoke_mesh

            out = _recon_spoke_sharded_cli(indata, cfg, make_spoke_mesh(device=device))
        else:
            out = recon_radial2d(
                indata, cfg, half_readback=args.half and cfg.adjoint, device=device
            )
    vprint(f"Elapsed time: {time.perf_counter() - start:.2f} s")
    if not root:
        return 0

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
