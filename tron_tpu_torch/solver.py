"""Iterative CGNR reconstruction (counterpart of `tron_tpu/solver.py`).

Solves the Ram-Lak-weighted least-squares problem of Knopp et al. 2007,

    min_x || W^(1/2) (A x - b) ||^2      =>      A^H W A x = A^H W b

with A = nufft_forward and W = diag(ramlak), readout 0 weighted out.  Three
operator modes, each a true adjoint pair or its normal operator:

  * "pair": the two CUDA kernels, the clip-mode degrid and the gridder (its
    exact-lattice mode when nro != nxos), which are one adjoint pair;
  * "transpose": the adjoint of the plain forward by autograd, as JAX takes
    `jax.linear_transpose` of its dense forward (PyTorch's complex vjp is
    already A^H v, where JAX needs conj(A^T conj v));
  * "toeplitz": the normal operator as a Toeplitz-embedded FFT convolution.

The loop stops where the JAX package's `lax.while_loop` stops
(`rs > rtol^2 <b, b>` and k < niter).  One iteration is one call of
``_cg_step``, whose stop test runs on the device: where ``rs > thresh`` is
false it leaves x, r, p and rs as they are, bit for bit, so a solve that
has converged stays converged; where it is true it steps by the CG formula.

On the card, with the pair's operators (or the Toeplitz normal operator on
the pair's right side) and no mesh axis, a solve is replayed from CUDA
graphs (`_CGGraph`, `graphs.py`), one set a geometry on static tensors: the
multiplier (Toeplitz only), the right side with the state CG starts from,
and the step, replayed ``niter`` times; the host reads nothing of the
device, and the cache key holds all the captured chains depend on, the
threshold's ``rtol`` included.  A geometry's first solve runs its prologue
and first step eagerly, then captures the three; every later one is three
kinds of replay.  Elsewhere (the CPU, the "transpose" mode, a coil- or
spoke-sharded solve) the eager loop builds the prologue eagerly, reads the
residual on the host before each step and leaves the loop at the first
false, one synchronisation per iteration.

Under a profiler a solve is the span ``tron.cgnr``; its multiplier's build
(Toeplitz only) ``tron.toeplitz_psf`` and its right side A^H W b with the
state ``tron.cgnr_rhs``, in that order, each one replay of its graph in a
graphed solve after a geometry's first; each iteration ``tron.cgnr_iter``:
in the eager loop the stop test's host read and the step (a solve that
stops early opens one more, which holds only the test); in a graphed solve
one replay of the step (a geometry's first iteration: the step run
eagerly, before the capture), so such a solve always opens ``niter`` of
them, those past convergence running a step that changes nothing.  The
captures, once per geometry after its first solve's first iteration, are
``tron.cgnr_graph``.  ``cgnr_counts()`` reads the solves and the
iterations they ran (a graphed solve's are counted in one int64 on its
device, which the captured step adds to); ``CGNR_GRAPH_COUNTS`` counts the
geometries captured, the solves replayed and the solves run by the eager
loop; ``CGNR_PROLOGUE_COUNTS`` the solves whose prologue was replayed and
those whose prologue ran eagerly (a geometry's first, and every eager
loop's); ``TOEPLITZ_COUNTS`` the multipliers built by each method
("nufft", the gridded build, or "exact", the DTFT sum it falls to off
gridos 2), a replayed build included.

Across ranks (`parallel/`): with coils sharded the three inner products of an
iteration are summed over each axis of ``reduce_axes``; with spokes sharded
(``spoke_axis``) every CG vector is replicated and A^H W (.) is summed over
that axis.  An axis is a ``parallel.distributed.MeshAxis`` (the JAX package
names the axis of the enclosing shard_map; here the handle carries the
process group).  The stop test reads the reduced scalar, the same bits on
every rank of the group, so all ranks leave the loop together.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from tron_tpu_torch import graphs
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.nufft import nufft_adjoint, nufft_adjoint_exact, nufft_forward, sdc_weights
from tron_tpu_torch.ops.degrid import lattice_radii
from tron_tpu_torch.parallel.distributed import MeshAxis, psum
from tron_tpu_torch.tracing import span

_cg_graphs = graphs.Cache()
CGNR_GRAPH_COUNTS = _cg_graphs.counts
reset_cgnr_graph_counts = _cg_graphs.reset_counts
# solves whose prologue (multiplier, right side, state) replayed its graphs
# and solves that ran it eagerly
CGNR_PROLOGUE_COUNTS = {"replayed": 0, "eager": 0}
_counts = {"solves": 0, "iterations": 0}
TOEPLITZ_COUNTS = {"nufft": 0, "exact": 0}
# the live iterations of graphed solves, one int64 a device
_live: dict = {}


def cgnr_counts() -> dict:
    """``{"solves": ..., "iterations": ...}``, so a caller can see an early
    stop; reads each device's count of graphed iterations (a device read)."""
    return {"solves": _counts["solves"],
            "iterations": _counts["iterations"] + sum(int(n) for n in _live.values())}


def reset_cgnr_counts() -> None:
    _counts.update(solves=0, iterations=0)
    for n in _live.values():
        n.zero_()


def reset_cgnr_prologue_counts() -> None:
    CGNR_PROLOGUE_COUNTS.update(replayed=0, eager=0)


def reset_toeplitz_counts() -> None:
    TOEPLITZ_COUNTS.update(nufft=0, exact=0)


def _weights(
    cfg: ReconConfig, nro: int, npe: int, device, sample_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Ram-Lak (or ideal) weights with readout 0 weighted out: the (nro,)
    row, or with a 0/1 ``sample_mask`` per spoke the (npe_local, nro) table
    that also weights a shard's padded spokes out."""
    w = sdc_weights(cfg, nro, npe, device).clone()
    # a fill on the device: ``w[0] = 0`` would copy a host scalar, which a
    # CUDA graph's capture refuses (the multiplier's build is captured)
    w[0].fill_(0)
    if sample_mask is not None:
        w = sample_mask.to(w.dtype)[:, None] * w
    return w


def _check_axes(reduce_axes, spoke_axis) -> None:
    for ax in (*reduce_axes, spoke_axis):
        if ax is not None and not isinstance(ax, MeshAxis):
            raise TypeError(f"a mesh axis is given as mesh.axis(name), a MeshAxis; got {ax!r}")
    if spoke_axis is not None and any(ax.name == spoke_axis.name for ax in reduce_axes):
        # image-domain vectors are already replicated along the spoke axis
        raise ValueError(f"spoke_axis {spoke_axis.name!r} must not also be in reduce_axes")


def toeplitz_fourier_kernel(
    angles: torch.Tensor,
    cfg: ReconConfig,
    nro: int,
    method: str = "auto",
    npe_total: int | None = None,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fourier multiplier of the Toeplitz-embedded normal operator,
    fft2(ifftshift(t)) of shape (2n, 2n) with n = nro // 2 and

        t[d] = sum_m w_m exp(+2i pi k_m . d / nro).

    ``method``: "nufft" grids the weights at doubled image size with the
    fast adjoint (the doubled-frequency identity holds only at gridos 2);
    "exact" sums the DTFT adjoint in chunks; "auto" is "nufft" when nro ==
    nxos, else "exact".  Readout 0 is weighted out.

    ``npe_total`` and ``sample_mask`` serve spoke-sharded CGNR: ``angles``
    then holds one shard's spokes, the weights come from the frame's spoke
    count ``npe_total``, padded spokes (mask 0) weigh nothing, and the
    shards' kernels sum to the frame's (t is linear over samples)."""
    npe = int(angles.shape[0])
    n = nro // 2
    nxos = int(n * cfg.gridos)
    w2d = _weights(cfg, nro, npe_total or npe, angles.device, sample_mask).expand(npe, nro)
    if method == "auto":
        method = "nufft" if nro == nxos else "exact"
        if method == "exact" and n > 64:
            warnings.warn(
                f"toeplitz_fourier_kernel: gridos={cfg.gridos} != 2 forces the exact-DTFT "
                f"PSF kernel (O((2n)^2 M) flops at n={n}); expect a slow per-frame "
                "precompute; use gridos=2 for the fast gridded kernel",
                stacklevel=2,
            )
    elif method == "nufft" and nro != nxos:
        # the doubled-frequency embedding holds only at gridos == 2: at any
        # other osf the even-slot samples land at the wrong doubled
        # frequencies, so refuse rather than return a wrong kernel
        raise ValueError(
            f"toeplitz_fourier_kernel(method='nufft') requires gridos == 2 "
            f"(got gridos={cfg.gridos}: nxos={nxos} != nro={nro}); use "
            "method='exact' or 'auto'"
        )

    TOEPLITZ_COUNTS[method] += 1
    if method == "exact":
        from tron_tpu_torch.oracle.dtft import dtft2_adjoint_chunked

        kr = lattice_radii(nro, nro, angles.device)
        kx = (kr[None, :] * torch.cos(angles)[:, None]).reshape(-1)
        ky = (kr[None, :] * torch.sin(angles)[:, None]).reshape(-1)
        t = dtft2_adjoint_chunked(w2d.to(torch.complex64).reshape(-1), kx, ky, 2 * n, nro)
    else:
        w2 = torch.zeros((npe, 2 * nro), dtype=torch.complex64, device=angles.device)
        w2[:, ::2] = w2d
        # undo the gridder's 1/(nxos'*npe) scale at the doubled geometry
        # (nro' = 2*nro, so nxos' = int(nro * gridos))
        t = nufft_adjoint(w2, angles, cfg, apply_sdc=False) * (int(nro * cfg.gridos) * npe)
    return torch.fft.fft2(torch.fft.ifftshift(t, dim=(-2, -1)))


def toeplitz_apply(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """Apply the Toeplitz-embedded normal operator: zero-pad the (..., n, n)
    image into the corner of a (2n, 2n) grid, multiply in Fourier space,
    crop back."""
    n = x.shape[-1]
    xp = x.new_zeros(x.shape[:-2] + (2 * n, 2 * n), dtype=torch.complex64)
    xp[..., :n, :n] = x
    y = torch.fft.ifft2(torch.fft.fft2(xp) * mult)
    return y[..., :n, :n].to(x.dtype)


def _transpose_adjoint(fwd, img_shape, dtype, device):
    """z -> A^H z for the linear map fwd, by one vjp at zero: PyTorch's
    complex vjp is the conjugate-transpose product."""
    _, vjp = torch.func.vjp(fwd, torch.zeros(img_shape, dtype=dtype, device=device))
    return lambda z: vjp(z)[0]


def _resolve(operators: str, cfg: ReconConfig, device) -> tuple[str, bool]:
    """``operators`` of cgnr_radial2d as (the adjoint pair's mode, "pair" or
    "transpose"; whether the normal operator is the Toeplitz one): "auto"
    is "toeplitz" under cfg.toeplitz, and "auto" and "toeplitz" take the
    kernel pair on a CUDA device, the autograd transpose elsewhere."""
    if operators == "auto" and cfg.toeplitz:
        operators = "toeplitz"
    toeplitz = operators == "toeplitz"
    if operators in ("auto", "toeplitz"):
        operators = "pair" if device.type == "cuda" else "transpose"
    return operators, toeplitz


def _operators(
    angles: torch.Tensor,
    cfg: ReconConfig,
    nro: int,
    img_shape: tuple,
    w: torch.Tensor,
    operators: str,
    spoke_axis: MeshAxis | None = None,
    npe_total: int | None = None,
    sample_mask: torch.Tensor | None = None,
):
    """(A^H W, A^H W A) of one operator mode, as two functions; ``w`` is the
    (nro,) weight row, or a shard's (npe, nro) table.  ``operators`` as in
    cgnr_radial2d, "auto" resolved by the device of ``w``.  With
    ``spoke_axis`` the spokes are one shard's and A^H W (.) is summed over
    the axis (with "toeplitz": the multiplier, once)."""
    npe = int(angles.shape[0])
    nxos = int((nro // 2) * cfg.gridos)
    operators, toeplitz = _resolve(operators, cfg, w.device)

    if operators == "pair":
        # the clip-mode forward is the exact transpose of the gridding
        # adjoint; at gridos != 2 the trunc-resample of the default adjoint
        # is a poor forward model, so the pair takes the exact lattice
        def fwd(x):
            return nufft_forward(x, angles, cfg, nro=nro, wrap=False)

        def AHW(y):
            if nro == nxos:
                out = nufft_adjoint(w * y, angles, cfg, apply_sdc=False)
            else:
                out = nufft_adjoint_exact(w * y, angles, cfg)
            # undo the gridder's reference scale (this shard's 1/(nxos*npe))
            return psum(out * (nxos * npe), spoke_axis)

    elif operators == "transpose":
        # the plain forward (backend "jnp"), whose autograd adjoint exists
        cfg_t = dataclasses.replace(cfg, backend="jnp")

        def fwd(x):
            return nufft_forward(x, angles, cfg_t, nro=nro)

        adj = _transpose_adjoint(fwd, img_shape, w.dtype, w.device)

        def AHW(y):
            return psum(adj(w * y), spoke_axis)

    else:
        raise ValueError(f"unknown operators {operators!r}")

    if toeplitz:
        with span("tron.toeplitz_psf"):
            mult = toeplitz_fourier_kernel(
                angles, cfg, nro, npe_total=npe_total, sample_mask=sample_mask
            )
            # after this one sum the iterations need no collective
            mult = psum(mult, spoke_axis)
        return AHW, lambda x: toeplitz_apply(x, mult)
    return AHW, lambda x: AHW(fwd(x))


def _inner(a: torch.Tensor, bb: torch.Tensor, reduce_axes: tuple = ()) -> torch.Tensor:
    """Re <a, bb>, summed over each mesh axis of ``reduce_axes``."""
    v = torch.sum(torch.conj(a) * bb).real
    for ax in reduce_axes:
        v = psum(v, ax)
    return v


def _cg_step(x, r, p, rs, thresh, normal, inner) -> torch.Tensor:
    """One CG iteration on the state (x, r, p, rs) in place, with the stop
    test on the device; returns it, ``rs > thresh``, as a device bool.
    Where it is true the state takes the CG formula's values; where it is
    false ``torch.where`` keeps every bit of the state, so a converged solve
    stays converged.  Everything is computed from the state before any of it
    is written."""
    live = rs > thresh
    Ap = normal(p)
    alpha = rs / torch.clamp(inner(p, Ap), min=1e-30)
    x_new = x + alpha.to(x.dtype) * p
    r_new = r - alpha.to(r.dtype) * Ap
    rs_new = inner(r_new, r_new)
    beta = rs_new / torch.clamp(rs, min=1e-30)
    p_new = r_new + beta.to(p.dtype) * p
    for old, new in ((x, x_new), (r, r_new), (p, p_new), (rs, rs_new)):
        torch.where(live, new, old, out=old)
    return live


class _CGGraph:
    """One geometry's CG solve as three CUDA graphs: the multiplier (with
    ``toeplitz``), the right side with the state CG starts from, and the
    iteration.

    The pair's operators are built once on a static angle buffer and weight
    row (with ``toeplitz``, the normal operator reads a static multiplier
    that each solve rebuilds from its angles).  The geometry's first solve
    runs its prologue (the multiplier, A^H W d, the state) and its first
    iteration eagerly, which warms cuFFT's plans, the kernels and their
    cached tables, so the captures that follow copy nothing from the host;
    it then captures the iteration (one ``_cg_step`` on the static state,
    which also adds the live iteration to the device's count) and the
    prologue's two chains, launching nothing, and replays the iteration
    for the rest.  Every later solve copies its data into a static buffer
    and replays the three: no value of the prologue comes from the host,
    and the ``rtol`` its threshold bakes in is in the cache's key."""

    def __init__(self, data, angles, cfg, npe_total, toeplitz, rtol):
        npe, nro = data.shape[-2:]
        n = nro // 2
        self.cfg, self.nro, self.npe_total, self.rtol = cfg, nro, npe_total, rtol
        self.angles = angles.clone()
        self.data = torch.empty_like(data, memory_format=torch.contiguous_format)
        w = _weights(cfg, nro, npe_total or npe, data.device).to(data.dtype)
        img_shape = tuple(data.shape[:-2]) + (n, n)
        self.AHW, self.normal = _operators(self.angles, cfg, nro, img_shape, w, "pair")
        self.mult = None
        if toeplitz:
            self.mult = torch.zeros((2 * n, 2 * n), dtype=torch.complex64, device=data.device)
            self.normal = lambda x: toeplitz_apply(x, self.mult)
        self.psf = self.rhs = self.step = self.state = None

    def _psf(self, angles) -> None:
        self.mult.copy_(toeplitz_fourier_kernel(angles, self.cfg, self.nro,
                                                npe_total=self.npe_total))

    def _rhs(self, data) -> None:
        """b = A^H W d, and the state CG starts from: x 0, r and p b, rs and
        the stop threshold from <b, b>."""
        b = self.AHW(data)
        bb = _inner(b, b)
        if self.state is None:
            if b.device not in _live:
                _live[b.device] = torch.zeros((), dtype=torch.int64, device=b.device)
            vecs = tuple(torch.zeros_like(b) for _ in range(3))
            self.state = (*vecs, torch.zeros_like(bb), torch.zeros_like(bb), _live[b.device])
        x, r, p, rs, thresh, _ = self.state
        thresh.copy_(self.rtol * self.rtol * bb)
        x.zero_()
        r.copy_(b)
        p.copy_(b)
        rs.copy_(bb)

    def _step(self, x, r, p, rs, thresh, count) -> None:
        count.add_(_cg_step(x, r, p, rs, thresh, self.normal, _inner))

    def solve(self, data, angles, niter: int) -> torch.Tensor:
        self.angles.copy_(angles)
        first = self.step is None
        with span("tron.cgnr"):
            if self.mult is not None:
                with span("tron.toeplitz_psf"):
                    if first:
                        self._psf(self.angles)
                    else:
                        self.psf.replay()
            with span("tron.cgnr_rhs"):
                if first:
                    self._rhs(data)
                else:
                    self.rhs.replay(data)
            if first:
                with span("tron.cgnr_iter"):
                    self._step(*self.state)
                with span("tron.cgnr_graph"):
                    self.step = graphs.Chain(self._step, *self.state)
                    if self.mult is not None:
                        self.psf = graphs.Chain(self._psf, self.angles,
                                                counts=(TOEPLITZ_COUNTS,))
                    self.rhs = graphs.Chain(self._rhs, self.data)
                CGNR_GRAPH_COUNTS["captured"] += 1
            CGNR_PROLOGUE_COUNTS["eager" if first else "replayed"] += 1
            for _ in range(first, niter):
                with span("tron.cgnr_iter"):
                    self.step.replay()
            # the static x is overwritten by the next solve
            return self.state[0].clone()


def _graph_key(data, angles, cfg, toeplitz, npe_total, rtol) -> tuple:
    """The cache key of a graphed solve: all that its captured chains bake
    in, the threshold's ``rtol`` included."""
    return (data.device, tuple(data.shape), data.dtype, angles.dtype, cfg, cfg.kernel_tuning(),
            toeplitz, npe_total, rtol)


def cgnr_radial2d(
    data: torch.Tensor,
    angles: torch.Tensor,
    cfg: ReconConfig,
    niter: int | None = None,
    rtol: float = 1e-6,
    reduce_axes: tuple = (),
    operators: str = "auto",
    spoke_axis: str | None = None,
    npe_total: int | None = None,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """data: (..., npe, nro) -> image estimate (..., n, n).

    ``operators``: "pair" (the kernel pair), "transpose" (autograd adjoint
    of the plain forward), "toeplitz" (Toeplitz normal operator; the right
    side A^H W b still uses the fast adjoint once), or "auto": "toeplitz"
    when cfg.toeplitz is set, else "pair" for a CUDA tensor and "transpose"
    for a CPU tensor, as JAX picks by platform.

    ``reduce_axes``: the mesh axes the channels are sharded over; the inner
    products are summed over each, so every shard steps with the global
    alpha and beta.  ``spoke_axis``, ``npe_total``, ``sample_mask``:
    spoke-sharded CGNR (`parallel/spoke.py`): ``data`` and ``angles`` hold
    one shard's spokes, the weights come from the frame's ``npe_total``, and
    ``sample_mask`` (0/1 per local spoke) weights the shard's padding out.

    On a CUDA device with the pair's adjoint and no mesh axis, the solve
    replays CUDA graphs: its prologue and its iterations (the module's
    docstring)."""
    _check_axes(reduce_axes, spoke_axis)
    niter = cfg.niter if niter is None else niter
    mode, toeplitz = _resolve(operators, cfg, data.device)
    if (data.is_cuda and mode == "pair" and niter > 0 and not reduce_axes
            and spoke_axis is None and sample_mask is None):
        # a miss makes the graph; its first solve captures
        key = _graph_key(data, angles, cfg, toeplitz, npe_total, rtol)
        graph = _cg_graphs.get(key, lambda: _CGGraph(data, angles, cfg, npe_total, toeplitz, rtol))
        x = graph.solve(data, angles, niter)
        _counts["solves"] += 1
        CGNR_GRAPH_COUNTS["replayed"] += 1
        return x

    npe, nro = data.shape[-2:]
    n = nro // 2
    img_shape = tuple(data.shape[:-2]) + (n, n)
    # readout 0 (one sample per spoke at the highest |k|, never gridded) is
    # weighted out in every mode, so all modes solve one problem
    w = _weights(cfg, nro, npe_total or npe, data.device, sample_mask).to(data.dtype)

    def inner(a, bb):
        return _inner(a, bb, reduce_axes)

    with span("tron.cgnr"):
        AHW, normal = _operators(
            angles, cfg, nro, img_shape, w, operators, spoke_axis, npe_total, sample_mask
        )
        with span("tron.cgnr_rhs"):
            b = AHW(data)
        rs = inner(b, b)
        thresh = rtol * rtol * rs
        x, r, p = torch.zeros_like(b), b, b.clone()
        k = 0
        while k < niter:
            with span("tron.cgnr_iter"):
                if not bool(rs > thresh):
                    break
                _cg_step(x, r, p, rs, thresh, normal, inner)
            k += 1
    _counts["solves"] += 1
    _counts["iterations"] += k
    CGNR_GRAPH_COUNTS["eager"] += 1
    CGNR_PROLOGUE_COUNTS["eager"] += 1
    return x


def cgnr_or_adjoint(data: torch.Tensor, angles: torch.Tensor, cfg: ReconConfig) -> torch.Tensor:
    """Dispatch like the reference program (`src/tron.cu:753-758`)."""
    if cfg.niter > 0:
        return cgnr_radial2d(data, angles, cfg)
    return nufft_adjoint(data, angles, cfg)
