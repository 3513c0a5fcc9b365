"""The comparison that decides ``correct``: the frames the timed calls
returned, frame by frame, against the plain reference's frames of the same
input, at the timed sizes.  The reference is the one the cell's mix names
(`spec.reference`): combined images (F, n, n) of an adjoint series,
coil-samples (F, nc, npe1, nro) of a forward one.

Each kept frame reads ||served - reference|| / ||reference|| over all of
its values; a series fails when one of its frames reads above the cell's
limit (`limits/<cell>.json`) or when it raised.  The reference runs once
the window has closed, in blocks of frames, and reads no output of the
program but the frames it judges.
"""

from __future__ import annotations

import numpy as np
import torch


def frame_errors(served, ref: torch.Tensor) -> np.ndarray:
    """Relative L2 error of each frame, served (F, ...), host or device,
    against ref: over every axis but the first."""
    s = torch.as_tensor(served).to(ref.device)
    dims = tuple(range(1, ref.dim()))
    num = torch.linalg.vector_norm(s - ref, dim=dims)
    den = torch.linalg.vector_norm(ref, dim=dims)
    return (num / den).double().cpu().numpy()


def compare(indata: np.ndarray, reference, recon: dict, kept: dict, device,
            block: int = 32) -> dict:
    """Every kept frame against ``reference`` (the module `spec.reference`
    loads): kept maps a series' index to (frame indices, frames (F, ...)).
    Returns each series' worst frame error and the frames compared."""
    ref = reference.Series(indata, recon, device)
    need = sorted(set().union(*(set(int(z) for z in f) for f, _ in kept.values())))
    worst = {i: 0.0 for i in kept}
    for b0 in range(0, len(need), block):
        zs = need[b0:b0 + block]
        frames = ref.frames(zs, block=block)
        pos = {z: k for k, z in enumerate(zs)}
        for i, (idx, served) in kept.items():
            sel = [k for k, z in enumerate(idx) if int(z) in pos]
            if sel:
                e = frame_errors(served[sel], frames[[pos[int(idx[k])] for k in sel]])
                worst[i] = max(worst[i], float(np.max(np.nan_to_num(e, nan=np.inf))))
    return {"worst": worst, "frames": sum(len(f) for f, _ in kept.values())}
