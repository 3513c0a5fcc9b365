"""Coil combination and compression (counterpart of `tron_tpu/ops/coil.py`):
root sum of squares, the Walsh adaptive combine and SVD coil compression.

References: `src/tron.cu:255-268` (SoS), `:222-253` (power iteration),
`:270-302` (Walsh).  The JAX package leaves all of these to XLA, so here they
are plain PyTorch on the data's device.  The Walsh combine is vectorised over
pixels: the per-pixel channel covariance over a (2*npatch+1)^2 neighbourhood
is a box filter of the outer-product maps (zero padding equals the
reference's clamped patch: pixels outside contribute nothing), and the
dominant eigenvector comes from the same 5-step power iteration, run for
all pixels at once.  Any channel count works.
"""

from __future__ import annotations

import torch


def coil_combine_sos(coilimg: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Root-sum-of-squares over the channel axis; passthrough if singleton.

    Returns the input's (complex) dtype with zero imaginary part, matching
    the reference output convention (`src/tron.cu:263-264`).
    """
    if coilimg.shape[axis] == 1:
        return coilimg.select(axis, 0)
    mag = torch.sqrt(torch.sum(torch.abs(coilimg) ** 2, dim=axis))
    return mag.to(coilimg.dtype)


def _box_filter(x: torch.Tensor, npatch: int) -> torch.Tensor:
    """Sum over a (2*npatch+1)^2 neighbourhood with zero padding, separably,
    on the trailing two axes, as 2*(k-1) shifted-slice adds."""
    if npatch == 0:
        return x
    k = 2 * npatch + 1
    H, W = x.shape[-2], x.shape[-1]
    xp = x.new_zeros(tuple(x.shape[:-2]) + (H + 2 * npatch, W + 2 * npatch))
    xp[..., npatch : npatch + H, npatch : npatch + W] = x
    rows = xp[..., 0:H, :]
    for i in range(1, k):
        rows = rows + xp[..., i : i + H, :]
    out = rows[..., :, 0:W]
    for j in range(1, k):
        out = out + rows[..., :, j : j + W]
    return out


def coil_combine_walsh(
    coilimg: torch.Tensor,
    npatch: int = 1,
    niters: int = 5,
) -> torch.Tensor:
    """Walsh adaptive combine. coilimg: (C, ny, nx) complex.

    Returns (ny, nx) complex: sum_c conj(v_c) * img_c with v the dominant
    eigenvector of the local channel covariance.

    Everything stays channel-leading.  The covariance is kept as C*(C+1)/2
    Hermitian-unique (ny, nx) planes (A[c2,c1] = conj(A[c1,c2])), so the box
    filter and the power iteration's matrix-vector product are plane ops and
    the peak memory is about (C^2/2)*ny*nx*8 bytes per frame.
    """
    C = coilimg.shape[0]
    if C == 1:
        return coilimg[0]
    # Hermitian-unique covariance planes: A[c1, c2] for c1 <= c2 only
    pairs = [(c1, c2) for c1 in range(C) for c2 in range(c1, C)]
    outer = torch.stack([coilimg[c1] * torch.conj(coilimg[c2]) for c1, c2 in pairs])
    A = _box_filter(outer, npatch)                         # (P, ny, nx)
    idx = {p: i for i, p in enumerate(pairs)}

    def matvec(x):
        # y[c1] = sum_c2 A[c1, c2] * x[c2], using A[c2,c1] = conj(A[c1,c2])
        rows = []
        for c1 in range(C):
            acc = None
            for c2 in range(C):
                a = A[idx[(c1, c2)]] if c1 <= c2 else torch.conj(A[idx[(c2, c1)]])
                term = a * x[c2]
                acc = term if acc is None else acc + term
            rows.append(acc)
        return torch.stack(rows)

    # power iteration from the all-ones vector, for all pixels at once
    # (`src/tron.cu:222-253`); a zero vector is left as it is
    v = torch.ones_like(coilimg)                           # (C, ny, nx)
    for _ in range(niters):
        y = matvec(v)
        nrm = torch.sqrt(torch.sum(torch.abs(y) ** 2, dim=0, keepdim=True))
        v = y / torch.where(nrm > 0, nrm, torch.ones_like(nrm)).to(y.dtype)
    return torch.sum(torch.conj(v) * coilimg, dim=0)


def coil_combine_walsh_frames(
    stack: torch.Tensor,
    npatch: int = 1,
    niters: int = 5,
) -> torch.Tensor:
    """Walsh combine over a frame stack (nz, C, ny, nx) -> (nz, ny, nx),
    frame by frame, so the peak covariance memory is one frame's whatever
    nz is."""
    if stack.shape[1] == 1:
        return stack[:, 0]
    out = stack.new_empty((stack.shape[0],) + tuple(stack.shape[2:]))
    for z in range(stack.shape[0]):
        out[z] = coil_combine_walsh(stack[z], npatch, niters)
    return out


def coil_compress(data: torch.Tensor, ncomp: int) -> torch.Tensor:
    """SVD coil compression: (C, npe, nro) k-space -> (ncomp, npe, nro).

    The standard Buehrer/Huang SCC (the reference leaves it as a TODO,
    `src/tron.cu:765`): stack the samples as a (C, M) matrix, take the top
    eigenvectors of its C x C Gram matrix in descending order, rotate the
    data into that basis.  Each virtual coil is fixed only up to a phase.
    """
    C = data.shape[0]
    if ncomp >= C:
        return data
    X = data.reshape(C, -1)                       # (C, M)
    G = X @ X.conj().T
    _, vecs = torch.linalg.eigh(G)                # ascending eigenvalues
    basis = vecs.flip(-1)[:, :ncomp]              # top-ncomp components
    Y = basis.conj().T @ X
    return Y.reshape((ncomp,) + tuple(data.shape[1:]))
