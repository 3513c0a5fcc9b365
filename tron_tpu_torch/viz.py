"""Visualization helpers (counterpart of `tron_tpu/viz.py`), the rebuild of
the reference's MATLAB viz layer
(`src/mosaic.m`, `src/raview.m`, `src/racompare.m`, `src/rimp.m`,
`src/rkmp.m`, `src/whole_body_mosaic.m`): tile image stacks, show
real/imag/magnitude/phase strips, compare recons, dump .ra files to PNG.

matplotlib backend 'Agg', imported at the first call (without matplotlib
that call raises ImportError); every function writes a PNG and returns the
path.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def mosaic(stack: np.ndarray, path: str, ncols: int | None = None, title: str = ""):
    """Tile a (nz, ny, nx) magnitude stack into a grid image (src/mosaic.m)."""
    stack = np.abs(np.asarray(stack))
    nz = stack.shape[0]
    if ncols is None:
        ncols = int(np.ceil(np.sqrt(nz)))
    nrows = -(-nz // ncols)
    ny, nx = stack.shape[-2:]
    canvas = np.zeros((nrows * ny, ncols * nx), dtype=np.float32)
    for i in range(nz):
        r, c = divmod(i, ncols)
        canvas[r * ny : (r + 1) * ny, c * nx : (c + 1) * nx] = stack[i]
    plt = _plt()
    fig, ax = plt.subplots(figsize=(ncols * 2, nrows * 2))
    ax.imshow(canvas, cmap="gray")
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def rimp(img: np.ndarray, path: str, title: str = ""):
    """Real / imaginary / magnitude / phase strip (src/rimp.m)."""
    img = np.asarray(img)
    plt = _plt()
    fig, axes = plt.subplots(1, 4, figsize=(12, 3.2))
    panels = [
        (img.real, "real", "gray"),
        (img.imag, "imag", "gray"),
        (np.abs(img), "magnitude", "gray"),
        (np.angle(img), "phase", "twilight"),
    ]
    for ax, (p, name, cmap) in zip(axes, panels):
        im = ax.imshow(p, cmap=cmap)
        ax.set_title(name)
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, fraction=0.045)
    if title:
        fig.suptitle(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def compare(a: np.ndarray, b: np.ndarray, path: str, labels=("a", "b")):
    """Side-by-side magnitude + scaled difference (src/racompare.m,
    src/lmsediff.m overlay)."""
    from tron_tpu_torch.metrics import lmsediff, nrmse

    a = np.asarray(a)
    b = np.asarray(b)
    d = np.abs(lmsediff(a, b))
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(10, 3.4))
    for ax, (img, name) in zip(
        axes, [(np.abs(a), labels[0]), (np.abs(b), labels[1]), (d, "lms diff")]
    ):
        im = ax.imshow(img, cmap="gray")
        ax.set_title(name)
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, fraction=0.045)
    fig.suptitle(f"nrmse={nrmse(a, b):.2e}")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def raview(ra_path: str, out_path: str | None = None):
    """Dump a .ra file's frames to a mosaic PNG (src/raview.m)."""
    from tron_tpu_torch.io import ra_read

    arr = ra_read(ra_path)
    if out_path is None:
        out_path = str(ra_path) + ".png"
    # (d0, nt, nx, ny, nz) image files -> stack over nz
    a = np.asarray(arr)
    while a.ndim > 3:
        a = a[..., 0] if a.shape[-1] != max(a.shape) else a[0]
    if a.ndim == 2:
        a = a[None]
    if a.shape[-1] < a.shape[0]:
        a = np.moveaxis(a, -1, 0)
    return mosaic(a, out_path)


def rkmp(kspace: np.ndarray, path: str, title: str = ""):
    """k-space real/imag/log-magnitude/phase strip (src/rkmp.m)."""
    k = np.asarray(kspace)
    plt = _plt()
    fig, axes = plt.subplots(1, 4, figsize=(12, 3.2))
    logmag = np.log1p(np.abs(k))
    panels = [
        (k.real, "real", "gray"),
        (k.imag, "imag", "gray"),
        (logmag, "log magnitude", "viridis"),
        (np.angle(k), "phase", "twilight"),
    ]
    for ax, (p, name, cmap) in zip(axes, panels):
        im = ax.imshow(p, cmap=cmap)
        ax.set_title(name)
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, fraction=0.045)
    if title:
        fig.suptitle(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


if __name__ == "__main__":  # python -m tron_tpu_torch.viz file.ra [out.png]
    import sys

    out = raview(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)
    print(out)
