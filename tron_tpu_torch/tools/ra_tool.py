"""RawArray utility CLI: query / reshape / convert / diff / squash / half
(counterpart of `tron_tpu/tools/ra_tool.py`; numpy only, installed as
`tron-torch-ra`).

The reference's ra.h declares ra_query/ra_reshape/ra_convert/ra_squash/
ra_diff (ra.h:101-111) but ships only read/write/free; here the full
surface exists.  Usage:

    python -m tron_tpu_torch.tools.ra_tool query file.ra
    python -m tron_tpu_torch.tools.ra_tool reshape file.ra 2 3 4
    python -m tron_tpu_torch.tools.ra_tool convert file.ra out.ra --eltype 3 --elbyte 2
    python -m tron_tpu_torch.tools.ra_tool diff a.ra b.ra
    python -m tron_tpu_torch.tools.ra_tool squash file.ra       # drop size-1 dims
    python -m tron_tpu_torch.tools.ra_tool half c64.ra f16.ra   # <-> fp16 pair
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tron_tpu_torch.io import ra_convert, ra_query, ra_read, ra_write

_TYPE_NAMES = {0: "user", 1: "int", 2: "uint", 3: "float", 4: "complex"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ra")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("query")
    q.add_argument("file")

    r = sub.add_parser("reshape")
    r.add_argument("file")
    r.add_argument("dims", type=int, nargs="+")

    c = sub.add_parser("convert")
    c.add_argument("file")
    c.add_argument("out")
    c.add_argument("--eltype", type=int, required=True)
    c.add_argument("--elbyte", type=int, required=True)

    d = sub.add_parser("diff")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--rtol", type=float, default=0.0)

    s = sub.add_parser("squash")
    s.add_argument("file")

    hp = sub.add_parser(
        "half",
        help="complex file -> float16 re/im-pair file (leading dim of 2, "
        "the raread.m storage trick --half outputs use; halves bytes and "
        "upload time of streamed recons), or back, if given a pair file",
    )
    hp.add_argument("file")
    hp.add_argument("out")

    args = p.parse_args(argv)

    if args.cmd == "query":
        h = ra_query(args.file)
        print(f"type:  {_TYPE_NAMES.get(h.eltype, h.eltype)}{8 * h.elbyte}")
        print(f"dims:  {list(h.dims)}")
        print(f"size:  {h.size} B")
        print(f"flags: {h.flags}")
        return 0
    if args.cmd == "reshape":
        arr = ra_read(args.file)
        if int(np.prod(args.dims)) != arr.size:
            print("error: dims do not match element count", file=sys.stderr)
            return 1
        ra_write(arr.reshape(-1, order="F"), args.file, dims=tuple(args.dims))
        return 0
    if args.cmd == "convert":
        arr = ra_read(args.file)
        ra_write(ra_convert(arr, args.eltype, args.elbyte), args.out)
        return 0
    if args.cmd == "squash":
        arr = ra_read(args.file)
        dims = tuple(d for d in arr.shape if d != 1) or (1,)
        ra_write(arr.reshape(-1, order="F"), args.file, dims=dims)
        return 0
    if args.cmd == "half":
        arr = ra_read(args.file)
        if np.iscomplexobj(arr):
            pair = np.empty((2,) + arr.shape, np.float16)
            pair[0] = arr.real.astype(np.float16)
            pair[1] = arr.imag.astype(np.float16)
            ra_write(pair, args.out)
        elif arr.ndim == 6 and arr.shape[0] == 2:
            # the 6-D re/im-pair convention (io.native.radial_dims); a 5-D
            # plain-float file with 2 coils is NOT a pair: rejected below
            ra_write(
                (arr[0].astype(np.float32) + 1j * arr[1].astype(np.float32)
                 ).astype(np.complex64),
                args.out,
            )
        else:
            print("error: need a complex file or a re/im-pair file",
                  file=sys.stderr)
            return 1
        return 0
    if args.cmd == "diff":
        a = ra_read(args.a)
        b = ra_read(args.b)
        if a.shape != b.shape or a.dtype != b.dtype:
            print(f"differ: shape/dtype {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
            return 1
        if args.rtol > 0:
            ok = np.allclose(a, b, rtol=args.rtol, atol=0)
        else:
            ok = bool((np.asarray(a) == np.asarray(b)).all())
        if ok:
            print("identical")
            return 0
        err = float(
            np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-30)
        )
        print(f"differ: nrmse={err:.3e}")
        return 1
    return 2


if __name__ == "__main__":
    sys.exit(main())
