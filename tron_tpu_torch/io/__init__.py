"""`.ra` I/O (counterpart of `tron_tpu/io/__init__.py`)."""

from tron_tpu_torch.io.ra import (
    RA_MAGIC,
    RaHeader,
    RaWriter,
    dtype_to_eltype,
    eltype_to_dtype,
    ra_convert,
    ra_query,
    ra_read,
    ra_write,
)

__all__ = [
    "RA_MAGIC",
    "RaHeader",
    "RaWriter",
    "dtype_to_eltype",
    "eltype_to_dtype",
    "ra_convert",
    "ra_query",
    "ra_read",
    "ra_write",
]
