"""The comparison that decides ``correct``: the images the timed calls
returned, frame by frame, against the plain reference's frames of the same
input, at the timed sizes.

Each kept frame reads ||served - reference|| / ||reference|| over its
n x n image; a series fails when one of its frames reads above the cell's
limit (`limits/<cell>.json`) or when it raised.  The reference runs once
the window has closed, in blocks of frames, and reads no output of the
program but the images it judges.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.recon import Series


def frame_errors(served, ref: torch.Tensor) -> np.ndarray:
    """Relative L2 error of each frame, served (F, n, n), host or device,
    against ref."""
    s = torch.as_tensor(served).to(ref.device)
    num = torch.linalg.vector_norm(s - ref, dim=(-2, -1))
    den = torch.linalg.vector_norm(ref, dim=(-2, -1))
    return (num / den).double().cpu().numpy()


def compare(indata: np.ndarray, recon: dict, kept: dict, device, block: int = 32) -> dict:
    """Every kept frame against the reference: kept maps a series' index
    to (frame indices, images (F, n, n)).  Returns each series' worst frame
    error and the frames compared."""
    ref = Series(indata, recon, device)
    need = sorted(set().union(*(set(int(z) for z in f) for f, _ in kept.values())))
    worst = {i: 0.0 for i in kept}
    for b0 in range(0, len(need), block):
        zs = need[b0:b0 + block]
        frames = ref.frames(zs, block=block)
        pos = {z: k for k, z in enumerate(zs)}
        for i, (idx, imgs) in kept.items():
            sel = [k for k, z in enumerate(idx) if int(z) in pos]
            if sel:
                e = frame_errors(imgs[sel], frames[[pos[int(idx[k])] for k in sel]])
                worst[i] = max(worst[i], float(np.max(np.nan_to_num(e, nan=np.inf))))
    return {"worst": worst, "frames": sum(len(f) for f, _ in kept.values())}
