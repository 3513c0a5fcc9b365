"""Forward radial degridding (counterpart of `tron_tpu/ops/degrid.py`):
sample a centered oversampled k-space grid at radial trajectory points with
Kaiser-Bessel interpolation.

Each sample owns its output (a pure gather, the race-freedom property of the
reference, `src/tron.cu:540-577`), and the (int(2kw)+1)^2 neighbourhood is
walked with static offset loops.  ``degrid_radial2d`` is the plain version
of the CUDA degridding kernel (`ops/degrid_cuda.py`): its CPU twin and its
oracle on the card.  ``_degrid_dense`` is the separable dense form.

Conventions as in the JAX package: x = r cos t, y = r sin t, the grid
centred at n//2, sample u of a spoke at radius (u/nro - 1/2) * n
(`lattice_radii`, the one radius table of both kernels and both plain
versions).

With ``wrap`` at the bf16x2 and bf16x3 classes the readouts whose footprint
can cross the grid edge (`wrap_edge_readouts`) are computed at float32, as
JAX's wrap-edge patch computes them (`fp32_wrap_edges`).
"""

from __future__ import annotations

import functools
import math

import torch

from tron_tpu_torch.kernels.kb import kb_kernel
from tron_tpu_torch.ops.precision import bf16


@functools.cache
def _lattice_radii(nro: int, n: int, device: torch.device) -> torch.Tensor:
    ro = torch.arange(nro, dtype=torch.float32)
    return ((ro / nro - 0.5) * n).to(device)


def lattice_radii(nro: int, n: int, device=None) -> torch.Tensor:
    """Signed radius of each of nro readouts, in units of an n-point grid:
    (u/nro - 1/2) * n in float32 (`src/tron.cu:554, 560-561`).  Read only:
    the table is cached per geometry and device.

    Computed on the CPU, where torch divides exactly as JAX does (a CUDA
    division by a scalar multiplies by its reciprocal), then moved: the
    degridding kernel, the gridding kernel's exact lattice and both plain
    versions read this one table, so the operator pair shares its radii bit
    for bit on every device."""
    return _lattice_radii(nro, n, torch.device(device if device is not None else "cpu"))


def _mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """x mod m in [0, m) for a float tensor, exact as ``jnp.mod`` (fmod and
    a sign fix; ``torch.remainder`` divides and is not exact)."""
    y = torch.fmod(x, m)
    return torch.where(y < 0, y + m, y)


# The classes whose wrap-edge readouts JAX recomputes at float32: its patch
# runs at precision="highest" for them (`tron_tpu/nufft.py:294-302`).  At
# bfloat16 it runs at the TPU's default precision, which stays the class.
FP32_EDGE_CLASSES = ("bf16x2", "bf16x3")


def wrap_edge_readouts(nro: int, n: int, kernwidth: float) -> torch.Tensor:
    """The readouts of a spoke whose KB footprint can cross the edge of an
    n-point grid, sorted int64: the first and last ``ceil(kw nro / n) + 2``,
    JAX's index set exactly (`tron_tpu/nufft.py:221-224`)."""
    ekw = math.ceil(kernwidth * nro / n) + 1
    idx = set(range(0, min(ekw + 1, nro))) | set(range(max(nro - ekw - 1, 0), nro))
    return torch.tensor(sorted(idx), dtype=torch.int64)


def fp32_wrap_edges(matmul_dtype: str, wrap: bool) -> bool:
    """True when a degridding call at class ``matmul_dtype`` computes the
    wrap-edge readouts (`wrap_edge_readouts`) at float32 over the class's
    values: with ``wrap`` at a class of ``FP32_EDGE_CLASSES``, as JAX's
    patch (`tron_tpu/nufft.py:204-244`) overwrites them.  The one rule of
    the kernel wrapper (`degrid_cuda.py`) and of ``degrid_radial2d``."""
    return wrap and matmul_dtype in FP32_EDGE_CLASSES


def _positions(angles: torch.Tensor, nro: int, n: int, readouts=None):
    """Continuous sample columns and rows (xs, ys), each (npe, nro), or
    (npe, len(readouts)) at those readouts only."""
    kr = lattice_radii(nro, n, angles.device)
    if readouts is not None:
        kr = kr[readouts.to(kr.device)]
    ct = torch.cos(angles).to(torch.float32)
    st = torch.sin(angles).to(torch.float32)
    xs = kr[None, :] * ct[:, None] + n // 2
    ys = kr[None, :] * st[:, None] + n // 2
    return xs, ys


def degrid_radial2d(
    kgrid: torch.Tensor,
    angles: torch.Tensor,
    nro: int,
    kernwidth: float,
    beta: float,
    wrap: bool = True,
    matmul_dtype: str = "float32",
    readouts: torch.Tensor | None = None,
) -> torch.Tensor:
    """kgrid: (..., n, n) centered complex k-space; angles: (npe,).  Returns
    samples (..., npe, nro).

    ``wrap=True`` treats the grid as periodic (index mod n, the reference's
    `src/tron.cu:569-570`); ``wrap=False`` clips KB footprints at the grid
    edge, which makes degrid the exact transpose of the gridding op (which
    clips), as the CGNR operator pair requires.

    ``matmul_dtype`` is the precision class of the JAX kernel: "float32"
    weighs each neighbour by wx * wy; a bf16 class sums each neighbour row
    first, v = sum_x A G with A = wx and G rounded to bfloat16 and split
    (bfloat16 Ah Gh; bf16x2 Ah Gh + Ah Gl; bf16x3 Ah Gh + Ah Gl + Al Gh,
    `tron_tpu/ops/degrid_pallas.py:120-134`), then adds wy * v in fp32;
    with ``wrap`` at bf16x2 and bf16x3 the wrap-edge readouts are then
    computed at float32 over them (`fp32_wrap_edges`).

    ``readouts`` (int64 indices) computes only those readouts, (..., npe,
    len(readouts)), at ``matmul_dtype`` as given: the float32 pass of that
    rule."""
    if readouts is None and fp32_wrap_edges(matmul_dtype, wrap):
        edges = wrap_edge_readouts(nro, kgrid.shape[-1], kernwidth)
        out = _degrid_class(kgrid, angles, nro, kernwidth, beta, wrap, matmul_dtype)
        fp32 = degrid_radial2d(kgrid, angles, nro, kernwidth, beta, wrap, readouts=edges)
        return out.index_copy_(-1, edges.to(out.device), fp32)
    if matmul_dtype != "float32":
        return _degrid_class(kgrid, angles, nro, kernwidth, beta, wrap, matmul_dtype, readouts)
    n = kgrid.shape[-1]
    batch = tuple(kgrid.shape[:-2])
    flat = kgrid.reshape(batch + (n * n,))
    xs, ys = _positions(angles, nro, n, readouts)
    x0 = torch.ceil(xs - kernwidth).to(torch.int64)
    y0 = torch.ceil(ys - kernwidth).to(torch.int64)

    noff = int(2 * kernwidth) + 1
    out = kgrid.new_zeros(batch + xs.shape)
    for dx in range(noff):
        xu = x0 + dx
        wx = kb_kernel(xu.to(torch.float32) - xs, kernwidth, beta)
        if not wrap:
            wx = wx * ((xu >= 0) & (xu < n))
        iu = torch.remainder(xu, n)
        for dy in range(noff):
            yu = y0 + dy
            w = wx * kb_kernel(yu.to(torch.float32) - ys, kernwidth, beta)
            if not wrap:
                w = w * ((yu >= 0) & (yu < n))
            idx = torch.remainder(yu, n) * n + iu           # row-major (y, x)
            vals = torch.index_select(flat, -1, idx.reshape(-1))
            out = out + vals.reshape(batch + idx.shape) * w.to(kgrid.dtype)
    return out


def _degrid_class(kgrid, angles, nro, kernwidth, beta, wrap, matmul_dtype,
                  readouts=None) -> torch.Tensor:
    """``degrid_radial2d`` at a bf16 class, every readout at the class: rows
    dy outer, each row's sum over x at the class, then times wy."""
    n = kgrid.shape[-1]
    batch = tuple(kgrid.shape[:-2])
    flat = kgrid.reshape(batch + (n * n,))
    gh = bf16(flat)
    gl = bf16(flat - gh)
    xs, ys = _positions(angles, nro, n, readouts)
    x0 = torch.ceil(xs - kernwidth).to(torch.int64)
    y0 = torch.ceil(ys - kernwidth).to(torch.int64)
    noff = int(2 * kernwidth) + 1

    def weight(u, pos):
        w = kb_kernel(u.to(torch.float32) - pos, kernwidth, beta)
        return w if wrap else w * ((u >= 0) & (u < n))

    out = kgrid.new_zeros(batch + xs.shape)
    for dy in range(noff):
        yu = y0 + dy
        wy = weight(yu, ys)
        v = kgrid.new_zeros(out.shape)
        for dx in range(noff):
            xu = x0 + dx
            a = weight(xu, xs)
            ah = bf16(a)
            idx = (torch.remainder(yu, n) * n + torch.remainder(xu, n)).reshape(-1)

            def near(g):
                return torch.index_select(g, -1, idx).reshape(batch + xu.shape)

            vh = near(gh)
            v = v + vh * ah
            if matmul_dtype in ("bf16x2", "bf16x3"):
                v = v + near(gl) * ah
            if matmul_dtype == "bf16x3":
                v = v + vh * bf16(a - ah)
        out = out + v * wy
    return out


def _degrid_dense(
    kgrid: torch.Tensor,
    angles: torch.Tensor,
    nro: int,
    kernwidth: float,
    beta: float,
    pe_chunk: int = 8,
    wrap: bool = True,
) -> torch.Tensor:
    """Separable dense formulation (the forward mirror of ops/grid.py):

        s[p, ro] = sum_y B[p, ro, y] * sum_x A[p, ro, x] * G[y, x]

    with A/B the KB weights of the sample against every grid column/row.
    The periodic wrap of the gather is reproduced by wrapping the KB
    distance into [-n/2, n/2)."""
    n = kgrid.shape[-1]
    xs, ys = _positions(angles, nro, n)
    grid_pos = torch.arange(n, dtype=torch.float32, device=kgrid.device)

    def wrapped_kb(d):
        if wrap:
            d = _mod(d + n / 2, n) - n / 2
        return kb_kernel(d, kernwidth, beta).to(kgrid.dtype)

    chunks = []
    for p0 in range(0, angles.shape[0], pe_chunk):
        xc = xs[p0 : p0 + pe_chunk]                   # (P, nro)
        yc = ys[p0 : p0 + pe_chunk]
        A = wrapped_kb(xc[..., None] - grid_pos)      # (P, nro, n)
        B = wrapped_kb(yc[..., None] - grid_pos)
        V = torch.einsum("prx,...yx->...pry", A, kgrid)
        chunks.append(torch.einsum("pry,...pry->...pr", B, V))
    return torch.cat(chunks, dim=-2)
