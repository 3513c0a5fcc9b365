"""The plain reference of TRON's forward operator, in PyTorch: the radial
coil-samples that a forward run (`tron in.ra out.ra`, no `-a`) synthesises
from a stack of coil images, written from the method (Kaiser-Bessel
degridding of golden-angle spokes, TRON, MRM 2018, doi:10.1002/mrm.27497,
and the reference program's forward pipeline, `src/tron.cu:639-649`) and
not from the program under test: it imports nothing of it.

Each frame, coil by coil: the deapodisation (division by the KB window's
Fourier transform over the image, `nufft.deapod_weights`; before the
zero-pad to nxos = gridos n, which is the same since the pad is zero), the
centred unnormalised forward FFT, and then every sample (pe, ro) at radius
(ro/nro - 1/2) nxos along its spoke's angle, nro = nxos, gathers the grid
points within the kernel's half-width on each axis, weighted by the
separable KB window (`nufft.kb`), the grid taken as periodic: index mod
nxos, as `(xu+n)%n` does (`src/tron.cu:540-577`).

Every frame is synthesised on the one angle set that starts at
``skip_angles``: int(u nro) golden-angle spokes (`nufft.golden_angles`),
the program's documented contract for the forward (`recon_radial2d`).
There this departs from `src/tron.cu` as SURVEY.md records it: its
degridding kernel takes the linear angle pe pi / npe whatever the flags
(`src/tron.cu:555`), where its gridding kernel takes the golden angle
(`:509`).

Everything is computed in float32 with the KB and deapodisation weights and
the sample positions in float64, TF32 off.  ``quant`` rounds the operands
of the gather, as a kernel at a lower precision would: the grid values and
the x-weights, whose products are summed along each neighbour row before
the row's y-weight is applied (`nufft.rounding`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import nufft

# the recon settings the reference works out, each with the values it takes
# (None: any); a forward ignores the sliding window's slide
SETTINGS = {"adjoint": (False,), "golden_angle": (True,), "data_undersamp": None,
            "prof_slide": None, "gridos": None, "kernwidth": None, "skip_angles": None,
            "niter": (0,)}


def centered_fft2(img: torch.Tensor) -> torch.Tensor:
    """Centred image -> centred k-space, the forward DFT without scaling."""
    ax = (-2, -1)
    return torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(img, dim=ax), dim=ax), dim=ax)


def _wrapped_taps(pos: torch.Tensor, kernwidth: float, beta: float, n: int):
    """The grid points within the kernel of each position ``pos`` (float64,
    in points of a periodic n-point axis): per tap, the point's index mod n
    and its KB weight (float32)."""
    first = torch.floor(pos - kernwidth) + 1
    taps = []
    for t in range(math.ceil(2 * kernwidth)):
        p = first + t
        taps.append((torch.remainder(p, n).long(), nufft.kb(pos - p, kernwidth, beta)
                     .to(torch.float32)))
    return taps


def degrid(kgrid: torch.Tensor, angles: torch.Tensor, nro: int, kernwidth: float,
           quant: str = "float32") -> torch.Tensor:
    """Grids (F, C, n, n) complex64 [y, x], centred at n//2 -> samples (F,
    C, npe, nro) complex64 at radii (ro/nro - 1/2) n along ``angles``
    (npe,), the grid periodic."""
    F, C, n, _ = kgrid.shape
    dev = kgrid.device
    beta = nufft.kb_beta(kernwidth)
    q = nufft.rounding(quant)
    r = (torch.arange(nro, dtype=torch.float64, device=dev) / nro - 0.5) * n
    a = angles.to(dev, torch.float64)[:, None]
    xt = _wrapped_taps(r * torch.cos(a) + n // 2, kernwidth, beta, n)     # (npe, nro) each
    yt = _wrapped_taps(r * torch.sin(a) + n // 2, kernwidth, beta, n)
    # per grid point, the coils' real and imaginary parts side by side
    g = torch.view_as_real(q(kgrid)).permute(0, 2, 3, 1, 4).reshape(F, n * n, 2 * C)
    acc = torch.zeros((F, a.shape[0] * nro, 2 * C), dtype=torch.float32, device=dev)
    for iy, wy in yt:
        row = torch.zeros_like(acc)
        for ix, wx in xt:
            row += g.index_select(1, (iy * n + ix).reshape(-1)) * q(wx).reshape(1, -1, 1)
        acc += row * wy.reshape(1, -1, 1)
    out = acc.reshape(F, a.shape[0], nro, C, 2).permute(0, 3, 1, 2, 4).contiguous()
    return torch.view_as_complex(out)


class Series:
    """One forward series' input, coil images in `.ra` dims (nc, 1, nx, ny,
    nz) in host memory, and its frames' geometry, on ``device``."""

    def __init__(self, indata: np.ndarray, recon: dict, device):
        for k, v in recon.items():
            if k not in SETTINGS or (SETTINGS[k] is not None and v not in SETTINGS[k]):
                raise ValueError(f"the reference does not work out the recon setting {k}={v!r}")
        nc, nt, nx, ny, nz = indata.shape
        if nt != 1 or nx != ny:
            raise ValueError(f"the reference takes one repetition of square images, got "
                             f"{indata.shape}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.kw = float(recon["kernwidth"])
        self.n, self.nz = nx, nz
        self.nxos = int(nx * recon["gridos"])
        self.nro = self.nxos
        self.npe = int(recon["data_undersamp"] * self.nro)
        self.angles = nufft.golden_angles(self.npe, recon["skip_angles"]).to(self.device)
        # (nz, ny, nx, nc): a frame is one contiguous run of a `.ra` array
        self.images = np.asarray(indata)[:, 0].T

    def coil_images(self, frames: list[int]) -> torch.Tensor:
        """The frames' coil images (F, C, n, n) [y, x] on the device."""
        blk = np.ascontiguousarray(self.images[frames])
        return torch.from_numpy(blk).to(self.device).permute(0, 3, 1, 2)

    def forward(self, img: torch.Tensor, quant: str) -> torch.Tensor:
        """Coil images (F, C, n, n) -> their samples (F, C, npe, nro)."""
        w = (self.nxos - self.n) // 2
        x = torch.zeros(img.shape[:2] + (self.nxos, self.nxos), dtype=torch.complex64,
                        device=self.device)
        x[..., w:w + self.n, w:w + self.n] = nufft.deapodize(img, self.nxos, self.kw)
        return degrid(centered_fft2(x), self.angles, self.nro, self.kw, quant)

    def frames(self, frames: list[int], quant: str = "float32", block: int = 32
               ) -> torch.Tensor:
        """The coil-samples (F, C, npe, nro) complex64 of ``frames``,
        ``block`` frames at a time."""
        return torch.cat([self.forward(self.coil_images(frames[i:i + block]), quant)
                          for i in range(0, len(frames), block)])
