"""Windowed .ra reads and region writes (counterpart of
`tron_tpu/io/native.py:166-285`).

The JAX package routes these through its C++ helper (`tron_tpu/_native/`)
and falls back to Python seeks and reads; the port has the Python path
only (the helper is host I/O, ROADMAP A18).
"""

from __future__ import annotations

import os

import numpy as np

from tron_tpu_torch.io import ra as _py


def radial_dims(hdr) -> tuple[int, int, int, int, int, bool]:
    """(nc, nt, nro, npe1, npe2, pair) of a radial .ra header.

    ``pair`` marks the float re/im-pair storage convention (a leading dim
    of 2, the raread.m trick used by ``--half`` outputs,
    `src/raread.m:25-57`); plain 5-D files (complex or float) have
    pair=False."""
    dims = [int(d) for d in hdr.dims]
    pair = (
        len(dims) >= 6
        and dims[0] == 2
        and not np.issubdtype(hdr.dtype, np.complexfloating)
    )
    base = dims[1:] if pair else dims
    if len(base) < 4:
        raise ValueError(f"expected a 5-D radial .ra, got dims {dims}")
    npe2 = base[4] if len(base) > 4 else 1
    return base[0], base[1], base[2], base[3], npe2, pair


def ra_read_profiles(path, pe0: int, npe: int) -> np.ndarray:
    """Profiles [pe0, pe0+npe) of a radial .ra file, read without loading
    the whole acquisition: complex64 (nc, nt, nro, npe) (the reference's
    per-frame H2D window copies, `src/tron.cu:738-748`, as a seek and read).

    Handles complex files, plain float files (promoted), and the float
    re/im-pair convention of ``--half`` outputs (6-D with a leading dim of
    2; the pair stride is accounted for in the per-profile seek)."""
    hdr = _py.ra_query(path)
    out, nc, nt, nro, pair = _read_profile_window(path, hdr, pe0, npe)
    return _decode_profile_window(out, npe, nc, nt, nro, pair, hdr.dtype)


def _read_profile_window(path, hdr, pe0: int, npe: int, pe2: int = 0):
    """Raw window read of profiles [pe0, pe0+npe) of kz-slice ``pe2``:
    returns (flat elements, nc, nt, nro, pair).  One contiguous region per
    call: profiles are the second-slowest on-disk axis (npe2 slowest)."""
    nc, nt, nro, npe1, _, pair = radial_dims(hdr)
    if pe0 < 0 or npe < 0 or pe0 + npe > npe1:
        raise ValueError(f"profiles [{pe0}, {pe0 + npe}) outside [0, {npe1})")
    unit = 2 if pair else 1
    dtype = hdr.dtype
    per = unit * nc * nt * nro                     # elements per profile
    stride = per * dtype.itemsize                  # bytes per profile
    offset = (pe2 * npe1 + pe0) * stride
    with open(path, "rb") as f:
        f.seek(hdr.data_offset + offset)
        out = np.fromfile(f, dtype=dtype, count=npe * per)
    if out.size != npe * per:
        raise IOError(f"short read: got {out.size} of {npe * per} elements from {path}")
    if hdr.flags & _py.RA_FLAG_BIG_ENDIAN:
        out = out.astype(out.dtype.newbyteorder("<"))
    return out, nc, nt, nro, pair


def _decode_profile_window(out, npe, nc, nt, nro, pair, dtype):
    if pair:
        # on-disk order: re/im fastest, then nc, nt, nro, npe
        w = out.reshape(npe, nro, nt, nc, 2).astype(np.float32)
        cplx = (w[..., 0] + 1j * w[..., 1]).astype(np.complex64)
        return cplx.transpose(3, 2, 1, 0)
    # on-disk order within a profile: nc fastest, then nt, then nro
    arr = out.reshape(npe, nro, nt, nc).transpose(3, 2, 1, 0)
    if not np.issubdtype(dtype, np.complexfloating):
        arr = arr.astype(np.complex64)
    return arr


def ra_read_profiles_stack(path, pe0: int, npe: int) -> np.ndarray:
    """Profiles [pe0, pe0+npe) of a 3-D stack-of-stars .ra at every kz
    encoding: complex64 (nc, nt, nro, npe, npe2), the windowed loader
    behind the streamed `-3` recon.

    npe2 is the slowest on-disk axis, so this is one contiguous region read
    per kz encoding (npe2 seeks); complex, plain-float and fp16-pair files
    all work (the decode of ``ra_read_profiles``)."""
    hdr = _py.ra_query(path)
    npe2 = radial_dims(hdr)[4]
    stack = None
    for pe2 in range(npe2):
        out, nc, nt, nro, pair = _read_profile_window(path, hdr, pe0, npe, pe2)
        plane = _decode_profile_window(out, npe, nc, nt, nro, pair, hdr.dtype)
        if stack is None:
            # preallocated: peak host memory is the window plus one plane.
            # Fortran order is the disk's (kz slowest, coil fastest), so each
            # plane, itself a transposed view of its region, lands as one
            # contiguous copy
            stack = np.empty(plane.shape + (npe2,), np.complex64, order="F")
        stack[..., pe2] = plane
    return stack


def ra_write_region(path, byte_offset: int, buf: np.ndarray) -> None:
    """pwrite ``buf`` into the .ra data payload of ``path`` at
    ``byte_offset`` (the file must already carry its header, as
    ``io.ra.RaWriter`` writes it)."""
    hdr = _py.ra_query(path)
    buf = np.ascontiguousarray(buf)
    if byte_offset < 0 or byte_offset + buf.nbytes > hdr.size:
        raise ValueError(
            f"region [{byte_offset}, {byte_offset + buf.nbytes}) exceeds payload {hdr.size}"
        )
    fd = os.open(path, os.O_WRONLY)
    try:
        _py.pwrite_all(fd, buf, hdr.data_offset + byte_offset)
    finally:
        os.close(fd)
