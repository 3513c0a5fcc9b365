"""RawArray (.ra) file format, numpy only (counterpart of `tron_tpu/io/ra.py`;
copied, since importing any `tron_tpu` module imports JAX).  ``RaWriter``'s
region writes go through the port's C++ helper (`io/native.py`), or with
``native=False`` through ``os.pwrite``.

Byte-identical to the spec of the reference implementation
(`src/ra.h:38-72`): a little-endian stream of u64 fields
{magic, flags, eltype, elbyte, size, ndims, dims[ndims]} followed by the raw
contiguous data.  `dims[0]` is the fastest-varying dimension (Fortran
convention).

Element types (ra.h:63-72):  0 = user, 1 = int, 2 = uint, 3 = float,
4 = complex.  Flags (ra.h:54-57): bit 0 = big endian, bit 1 = compressed;
any higher bit is an unknown-future-capability flag and triggers a
forward-compat warning on read, like `src/ra.cu:98-102`.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np

RA_MAGIC = 0x7961727261776172  # "rawarray" little-endian (ra.h:51)

RA_FLAG_BIG_ENDIAN = 1 << 0
RA_FLAG_COMPRESSED = 1 << 1
RA_KNOWN_FLAGS = RA_FLAG_BIG_ENDIAN | RA_FLAG_COMPRESSED

RA_TYPE_USER = 0
RA_TYPE_INT = 1
RA_TYPE_UINT = 2
RA_TYPE_FLOAT = 3
RA_TYPE_COMPLEX = 4

_ELTYPE_KIND = {
    RA_TYPE_INT: "i",
    RA_TYPE_UINT: "u",
    RA_TYPE_FLOAT: "f",
    RA_TYPE_COMPLEX: "c",
}
_KIND_ELTYPE = {v: k for k, v in _ELTYPE_KIND.items()}


@dataclasses.dataclass
class RaHeader:
    flags: int
    eltype: int
    elbyte: int
    size: int
    ndims: int
    dims: tuple[int, ...]

    @property
    def dtype(self) -> np.dtype:
        dt = eltype_to_dtype(self.eltype, self.elbyte)
        if self.flags & RA_FLAG_BIG_ENDIAN:
            dt = dt.newbyteorder(">")
        return dt

    @property
    def data_offset(self) -> int:
        return 8 * (6 + self.ndims)


def eltype_to_dtype(eltype: int, elbyte: int) -> np.dtype:
    if eltype == RA_TYPE_USER:
        return np.dtype(("V", elbyte))  # opaque bytes
    try:
        kind = _ELTYPE_KIND[eltype]
    except KeyError:
        raise ValueError(f"unknown ra eltype {eltype}") from None
    return np.dtype(f"<{kind}{elbyte}")


def dtype_to_eltype(dtype: np.dtype) -> tuple[int, int]:
    dtype = np.dtype(dtype)
    if dtype.kind == "V":
        return RA_TYPE_USER, dtype.itemsize
    try:
        return _KIND_ELTYPE[dtype.kind], dtype.itemsize
    except KeyError:
        raise ValueError(f"dtype {dtype} has no ra eltype") from None


def _read_header(f) -> RaHeader:
    head = np.frombuffer(f.read(48), dtype="<u8")
    if head.size < 6 or head[0] != RA_MAGIC:
        raise ValueError("Invalid RA file (bad magic).")
    flags, eltype, elbyte, size, ndims = (int(x) for x in head[1:6])
    if flags & ~RA_KNOWN_FLAGS:
        warnings.warn(
            "RA file written by a newer version of the format; "
            "correctness of input is not guaranteed.",
            stacklevel=3,
        )
    if flags & RA_FLAG_COMPRESSED:
        raise NotImplementedError("compressed .ra files are not supported")
    if flags & RA_FLAG_BIG_ENDIAN:
        warnings.warn(
            "big-endian RA file; byte-swapping data to native order",
            stacklevel=3,
        )
    dims = tuple(int(x) for x in np.frombuffer(f.read(8 * ndims), dtype="<u8"))
    return RaHeader(flags, eltype, elbyte, size, ndims, dims)


def ra_query(path: str | os.PathLike) -> RaHeader:
    """Read only the header of a .ra file (ra.h:102 `ra_query`)."""
    with open(path, "rb") as f:
        return _read_header(f)


def ra_read(
    path: str | os.PathLike,
    order: str = "F",
    mmap: bool = False,
) -> np.ndarray:
    """Read a .ra file into a numpy array with shape == stored dims.

    dims[0] is the fastest dimension on disk, so ``order="F"`` (default)
    returns shape ``dims`` exactly as the reference tools label it.
    ``order="C"`` returns the reversed-shape C-contiguous view instead.
    """
    with open(path, "rb") as f:
        hdr = _read_header(f)
        dtype = hdr.dtype
        count = hdr.size // dtype.itemsize
        if mmap:
            flat = np.memmap(
                path, dtype=dtype, mode="r", offset=hdr.data_offset, shape=(count,)
            )
        else:
            flat = np.fromfile(f, dtype=dtype, count=count)
    if flat.size != count:
        raise IOError(f"short read: got {flat.size} of {count} elements")
    if hdr.flags & RA_FLAG_BIG_ENDIAN:
        flat = flat.astype(flat.dtype.newbyteorder("<"))
    arr = flat.reshape(hdr.dims[::-1])  # C-order over reversed dims
    if order == "F":
        return arr.T  # shape == dims, F-ordered strides, no copy
    return arr


def ra_write(
    arr: np.ndarray,
    path: str | os.PathLike,
    dims: tuple[int, ...] | None = None,
) -> None:
    """Write ``arr`` to a .ra file.

    The array is interpreted so that ``arr.shape == dims`` with dims[0]
    fastest (Fortran layout on disk), mirroring :func:`ra_read`.  Pass
    ``dims`` to relabel the stored dimensionality (sizes must match).
    """
    arr = np.asarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    eltype, elbyte = dtype_to_eltype(arr.dtype)
    if dims is None:
        dims = arr.shape
    elif int(np.prod(dims)) != arr.size:
        raise ValueError(f"dims {dims} do not match array size {arr.size}")
    payload = np.asfortranarray(arr).reshape(-1, order="F")
    header = np.array(
        [RA_MAGIC, 0, eltype, elbyte, payload.nbytes, len(dims), *dims],
        dtype="<u8",
    )
    tmp = f"{os.fspath(path)}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(header.tobytes())
        payload.tofile(f)
    os.replace(tmp, path)


def ra_convert(arr: np.ndarray, eltype: int, elbyte: int) -> np.ndarray:
    """Convert an array to the numpy dtype of (eltype, elbyte).

    The float16 path uses numpy's IEEE-754 half conversions (ties-to-even),
    the algorithm the reference carries in `src/float16.cu:76-324`.
    """
    return np.asarray(arr).astype(eltype_to_dtype(eltype, elbyte))


def pwrite_all(fd: int, buf: np.ndarray, pos: int) -> None:
    """``os.pwrite`` all of ``buf`` at byte ``pos`` of ``fd`` (one call may
    write short: Linux caps it at ~2 GiB)."""
    view = memoryview(np.ascontiguousarray(buf)).cast("B")
    while len(view):
        n = os.pwrite(fd, view, pos)
        view = view[n:]
        pos += n


class RaWriter:
    """Incremental .ra writer: header up front, data landed by region
    (counterpart of `tron_tpu/io/ra.py:189-266`).

    The output half of the streaming recon driver: each reconstructed frame
    block lands in its region of the output file while the card computes
    the next block, the role of the reference's pinned-memory async D2H and
    per-frame output copies (`src/tron.cu:767-781`).  Frames are the
    slowest-varying .ra dimension (dims[0] is fastest), so each frame is
    one contiguous region.

    Writes go to a temp file; :meth:`close` atomically replaces ``path``
    (the contract of :func:`ra_write`), :meth:`abort` removes the temp.
    Region writes go through the C++ helper's ``ra_nat_write_region``
    (`io/native.py`), or with ``native=False`` through ``os.pwrite``.
    """

    def __init__(self, path: str | os.PathLike, dims: tuple[int, ...], dtype,
                 native: bool = True):
        self.path = os.fspath(path)
        self.native = native
        self.tmp = f"{self.path}.tmp.{os.getpid()}"
        self.dtype = np.dtype(dtype)
        if self.dtype.byteorder == ">":
            raise ValueError("RaWriter writes little-endian files only")
        eltype, elbyte = dtype_to_eltype(self.dtype)
        self.dims = tuple(int(d) for d in dims)
        self.size = int(np.prod(self.dims)) * elbyte
        header = np.array(
            [RA_MAGIC, 0, eltype, elbyte, self.size, len(self.dims), *self.dims],
            dtype="<u8",
        )
        self._data0 = header.nbytes
        self._fd = os.open(self.tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        os.write(self._fd, header.tobytes())
        os.truncate(self._fd, self._data0 + self.size)

    def write_at(self, elem_offset: int, arr: np.ndarray) -> None:
        """Land ``arr`` (already in on-disk element order) at element offset
        ``elem_offset`` of the data payload."""
        buf = np.ascontiguousarray(arr, dtype=self.dtype)
        off = int(elem_offset) * self.dtype.itemsize
        if off + buf.nbytes > self.size:
            raise ValueError(
                f"region [{off}, {off + buf.nbytes}) exceeds payload {self.size}"
            )
        if self.native:
            from tron_tpu_torch.io import native

            native.ra_write_region(self.tmp, off, buf)
        else:
            pwrite_all(self._fd, buf, self._data0 + off)

    def close(self) -> None:
        os.close(self._fd)
        os.replace(self.tmp, self.path)

    def abort(self) -> None:
        os.close(self._fd)
        try:
            os.unlink(self.tmp)
        except FileNotFoundError:
            pass

    def __enter__(self) -> "RaWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()
