"""The C++ .ra helper and the windowed .ra reads and region writes
(counterpart of `tron_tpu/io/native.py`).

`tron_tpu_torch/_native/ra_native.cpp` (the port's copy of the JAX
package's helper) is compiled with ``g++ -O3 -fPIC -std=c++17 -shared`` on
first use into `build/tron_tpu_torch/`, keyed by a hash of the source and
flags, and bound here with ctypes: whole-file reads and writes, a header
query, the float16 conversions, and the region read and write that the
streamed recon's windowed reads (``ra_read_profiles``,
``ra_read_profiles_stack``) and ``io.ra.RaWriter``'s region writes go
through.  A failed build raises with the compiler's output; nothing falls
back.  ``native=False`` takes the Python seek/read/pwrite path instead, the
helper's plain version, which gives the same bytes.

``CALLS`` counts the helper's region reads and writes, so a run can show
that its I/O went through it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from tron_tpu_torch import _build
from tron_tpu_torch.io import ra as _py

SOURCE = Path(__file__).resolve().parent.parent / "_native" / "ra_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
CALLS = {"read_region": 0, "write_region": 0}
_LOCK = threading.Lock()


class _RaNat(ctypes.Structure):
    _fields_ = [
        ("flags", ctypes.c_uint64),
        ("eltype", ctypes.c_uint64),
        ("elbyte", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
        ("ndims", ctypes.c_uint64),
        ("dims", ctypes.POINTER(ctypes.c_uint64)),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
    ]


def _declare(lib: ctypes.CDLL) -> None:
    ra, cp, u64, vp = ctypes.POINTER(_RaNat), ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p
    for name in ("ra_nat_read", "ra_nat_query", "ra_nat_write"):
        getattr(lib, name).argtypes = [cp, ra]
        getattr(lib, name).restype = ctypes.c_int
    lib.ra_nat_free.argtypes = [ra]
    lib.ra_nat_free.restype = None
    for name in ("ra_nat_read_region", "ra_nat_write_region"):
        getattr(lib, name).argtypes = [cp, u64, u64, vp]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("f32_to_f16", "f16_to_f32"):
        getattr(lib, name).argtypes = [vp, vp, ctypes.c_size_t]
        getattr(lib, name).restype = None


@functools.cache
def _load() -> ctypes.CDLL:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = _build.BUILD_DIR / f"libra_native_{h.hexdigest()[:16]}.so"
    if not out.is_file():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("g++ not found (set CXX): tron_tpu_torch's .ra helper is "
                               "compiled on first use")
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a temporary name of this process and thread, renamed into place
        # whole: processes building at once never see a half-written file
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return lib


def ensure_native() -> ctypes.CDLL:
    """Build (unless a library of this source exists) and load the helper;
    raises with the compiler's output if the build fails."""
    with _LOCK:  # the streamed recon's threads may ask first at once
        return _load()


def available() -> bool:
    """Whether the helper builds and loads here."""
    try:
        ensure_native()
    except (RuntimeError, OSError):
        return False
    return True


_ERRORS = {
    -1: "I/O error",
    -2: "bad magic",
    -3: "unsupported flags",
    -4: "alloc failed",
    -5: "region out of range",
}


def _check(rc: int, path) -> None:
    if rc != 0:
        raise (ValueError if rc == -5 else IOError)(f"ra_native: {_ERRORS.get(rc, rc)} for {path}")


def ra_query(path) -> _py.RaHeader:
    """The header of a .ra file through the helper (``ra.ra_query``'s
    counterpart); files with the big-endian or compressed flag go to the
    Python reader, which byte-swaps or refuses them."""
    a = _RaNat()
    lib = ensure_native()
    rc = lib.ra_nat_query(os.fspath(path).encode(), ctypes.byref(a))
    try:
        if rc == -3:
            return _py.ra_query(path)
        _check(rc, path)
        dims = tuple(int(a.dims[i]) for i in range(a.ndims))
        return _py.RaHeader(int(a.flags), int(a.eltype), int(a.elbyte), int(a.size),
                            int(a.ndims), dims)
    finally:
        lib.ra_nat_free(ctypes.byref(a))


def ra_read(path, order: str = "F") -> np.ndarray:
    """A whole .ra file through the helper (``ra.ra_read``'s counterpart,
    shape == dims for ``order="F"``); big-endian and compressed files go to
    the Python reader, as in the JAX package."""
    a = _RaNat()
    lib = ensure_native()
    rc = lib.ra_nat_read(os.fspath(path).encode(), ctypes.byref(a))
    try:
        if rc == -3:
            return _py.ra_read(path, order=order)
        _check(rc, path)
        dims = tuple(int(a.dims[i]) for i in range(a.ndims))
        dtype = _py.eltype_to_dtype(int(a.eltype), int(a.elbyte))
        buf = ctypes.string_at(a.data, a.size)
    finally:
        lib.ra_nat_free(ctypes.byref(a))
    arr = np.frombuffer(buf, dtype=dtype).reshape(dims[::-1])
    return arr.T if order == "F" else arr


def ra_write(arr: np.ndarray, path, dims=None) -> None:
    """Write ``arr`` as a .ra file through the helper (``ra.ra_write``'s
    counterpart: the same bytes; dims[0] fastest)."""
    arr = np.asarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    eltype, elbyte = _py.dtype_to_eltype(arr.dtype)
    if dims is None:
        dims = arr.shape
    elif int(np.prod(dims)) != arr.size:
        raise ValueError(f"dims {dims} do not match array size {arr.size}")
    payload = np.ascontiguousarray(np.asfortranarray(arr).reshape(-1, order="F"))
    dims_arr = (ctypes.c_uint64 * len(dims))(*dims)
    a = _RaNat(flags=0, eltype=eltype, elbyte=elbyte, size=payload.nbytes, ndims=len(dims),
               dims=dims_arr, data=ctypes.cast(payload.ctypes.data, ctypes.POINTER(ctypes.c_uint8)))
    _check(ensure_native().ra_nat_write(os.fspath(path).encode(), ctypes.byref(a)), path)


def f32_to_f16(x: np.ndarray) -> np.ndarray:
    """float32 -> float16 through the helper, round to nearest even (the
    reference's `src/float16.cu`; numpy's ``astype`` gives the same bits)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.uint16)
    ensure_native().f32_to_f16(x.ctypes.data, out.ctypes.data, x.size)
    return out.view(np.float16)


def f16_to_f32(x: np.ndarray) -> np.ndarray:
    """float16 -> float32 through the helper (exact)."""
    x = np.ascontiguousarray(x, dtype=np.float16).view(np.uint16)
    out = np.empty(x.shape, dtype=np.float32)
    ensure_native().f16_to_f32(x.ctypes.data, out.ctypes.data, x.size)
    return out


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


def ra_read_profiles(path, pe0: int, npe: int, native: bool = True) -> np.ndarray:
    """Profiles [pe0, pe0+npe) of a radial .ra file, read without loading
    the whole acquisition: complex64 (nc, nt, nro, npe) (the reference's
    per-frame H2D window copies, `src/tron.cu:738-748`, as a seek and read).

    Handles complex files, plain float files (promoted), and the float
    re/im-pair convention of ``--half`` outputs (6-D with a leading dim of
    2; the pair stride is accounted for in the per-profile seek).
    ``native=False``: the Python read instead of the helper's."""
    hdr = _py.ra_query(path)
    out, nc, nt, nro, pair = _read_profile_window(path, hdr, pe0, npe, native=native)
    return _decode_profile_window(out, npe, nc, nt, nro, pair, hdr.dtype)


def _read_profile_window(path, hdr, pe0: int, npe: int, pe2: int = 0, native: bool = True):
    """Raw window read of profiles [pe0, pe0+npe) of kz-slice ``pe2``:
    returns (flat elements, nc, nt, nro, pair).  One contiguous region per
    call: profiles are the second-slowest on-disk axis (npe2 slowest).  The
    helper's ``ra_nat_read_region`` reads it, or with ``native=False`` a
    Python seek and read."""
    nc, nt, nro, npe1, _, pair = radial_dims(hdr)
    if pe0 < 0 or npe < 0 or pe0 + npe > npe1:
        raise ValueError(f"profiles [{pe0}, {pe0 + npe}) outside [0, {npe1})")
    unit = 2 if pair else 1
    dtype = hdr.dtype
    per = unit * nc * nt * nro                     # elements per profile
    stride = per * dtype.itemsize                  # bytes per profile
    offset = (pe2 * npe1 + pe0) * stride
    if native:
        out = np.empty(npe * per, dtype=dtype)
        rc = ensure_native().ra_nat_read_region(os.fspath(path).encode(), offset, out.nbytes,
                                                out.ctypes.data)
        _check(rc, path)
        with _LOCK:  # the reader and writer threads count at once
            CALLS["read_region"] += 1
    else:
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


def ra_read_profiles_stack(path, pe0: int, npe: int, native: bool = True) -> np.ndarray:
    """Profiles [pe0, pe0+npe) of a 3-D stack-of-stars .ra at every kz
    encoding: complex64 (nc, nt, nro, npe, npe2), the windowed loader
    behind the streamed `-3` recon.

    npe2 is the slowest on-disk axis, so this is one contiguous region read
    per kz encoding (npe2 seeks); complex, plain-float and fp16-pair files
    all work (the decode of ``ra_read_profiles``).  ``native=False``: the
    Python reads instead of the helper's."""
    hdr = _py.ra_query(path)
    npe2 = radial_dims(hdr)[4]
    stack = None
    for pe2 in range(npe2):
        out, nc, nt, nro, pair = _read_profile_window(path, hdr, pe0, npe, pe2, native)
        plane = _decode_profile_window(out, npe, nc, nt, nro, pair, hdr.dtype)
        if stack is None:
            # preallocated: peak host memory is the window plus one plane.
            # Fortran order is the disk's (kz slowest, coil fastest), so each
            # plane, itself a transposed view of its region, lands as one
            # contiguous copy
            stack = np.empty(plane.shape + (npe2,), np.complex64, order="F")
        stack[..., pe2] = plane
    return stack


def ra_write_region(path, byte_offset: int, buf: np.ndarray, native: bool = True) -> None:
    """pwrite ``buf`` into the .ra data payload of ``path`` at
    ``byte_offset`` (the file must already carry its header, as
    ``io.ra.RaWriter`` writes it), through the helper's
    ``ra_nat_write_region`` or with ``native=False`` Python's ``os.pwrite``."""
    buf = np.ascontiguousarray(buf)
    if byte_offset < 0:
        raise ValueError(f"region offset {byte_offset} < 0")
    if native:
        rc = ensure_native().ra_nat_write_region(os.fspath(path).encode(), byte_offset,
                                                 buf.nbytes, buf.ctypes.data)
        _check(rc, path)
        with _LOCK:  # the reader and writer threads count at once
            CALLS["write_region"] += 1
        return
    hdr = _py.ra_query(path)
    if byte_offset + buf.nbytes > hdr.size:
        raise ValueError(
            f"region [{byte_offset}, {byte_offset + buf.nbytes}) exceeds payload {hdr.size}"
        )
    fd = os.open(path, os.O_WRONLY)
    try:
        _py.pwrite_all(fd, buf, hdr.data_offset + byte_offset)
    finally:
        os.close(fd)
