"""The precision classes of the JAX kernels (``matmul_dtype``), in torch.

A class says which operands of a contraction are rounded to bfloat16 and
which split products put the rounding loss back
(`tron_tpu/ops/grid_pallas.py:106-144`, `:1219-1231`,
`tron_tpu/ops/degrid_pallas.py:120-134`).  The plain versions of the kernels
round through ``torch.bfloat16`` casts here; the CUDA kernels take the class
as a template parameter (`csrc/precision.cuh`, whose codes are the order of
``MATMUL_DTYPES``).
"""

from __future__ import annotations

import torch

MATMUL_DTYPES = ("bfloat16", "bf16x2", "bf16x3", "float32")


def check(matmul_dtype: str) -> None:
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be one of {MATMUL_DTYPES}, got {matmul_dtype!r}")


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (ties to even, as ``jnp.astype``), as float32;
    a complex tensor's real and imaginary parts each."""
    if x.is_complex():
        return torch.complex(bf16(x.real), bf16(x.imag))
    return x.to(torch.bfloat16).to(torch.float32)


def class_dot(u: torch.Tensor, a: torch.Tensor, matmul_dtype: str) -> torch.Tensor:
    """u @ a at a precision class: each operand rounded to bfloat16 (xh)
    with its remainder xl = bf16(x - xh), and the products bfloat16 uh@ah;
    bf16x2 uh@ah + uh@al; bf16x3 uh@ah + ul@ah + uh@al, each an exact
    product summed in fp32 (the gridding kernels' order, with u the samples
    times y-weights and a the x-weights); "float32" is u @ a."""
    if matmul_dtype == "float32":
        return u @ a
    uh, ah = bf16(u), bf16(a)
    out = uh @ ah
    if matmul_dtype == "bf16x3":
        out = out + bf16(u - uh) @ ah
    if matmul_dtype in ("bf16x2", "bf16x3"):
        out = out + uh @ bf16(a - ah)
    return out
