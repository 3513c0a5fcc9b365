"""The port's CGNR with the Toeplitz normal operator (`tron -i N
--toeplitz`) against its plain reference, `tron_tpu_torch/oracle/toeplitz.py`,
on the CPU at a small geometry: 2 coils, 64 readouts, 74 spokes, frames of
25 spokes sliding by 21 (3 frames), 10 iterations, seeded complex Gaussian
samples.

Tolerances, relative L2 per frame:

- ``TOEPLITZ_TOL`` 5e-5, the card's route: the pair's right side A^H W d
  and the Toeplitz normal operator (here the gridder's plain version at
  float32; ``card_route`` puts the pair in "auto"'s place, as the card
  resolves it).  The port and the oracle compute one operator in float32,
  the port with KB weights and positions in float32, the oracle in
  float64, and both sum in other orders over the right side, the
  multiplier and 10 FFT convolutions a frame; they read 4e-6 to 6e-6.  The
  oracle with its gridding operands rounded to bfloat16, the precision the
  card computes, reads 4e-3 to 6e-3 and fails it.
- ``WRAP_TOL`` 1.5e-1, ``recon_radial2d`` on its CPU route: there "auto"
  takes the autograd transpose of the plain forward as the right side's
  A^H, which wraps KB footprints at the grid's edge (the JAX package's CPU
  route) where the gridding adjoint drops them; the highest-|k| readouts,
  which Ram-Lak weights most, differ, the Toeplitz normal operator is not
  that transpose's normal operator, and the frames read 4.7e-2 to 8.1e-2.
- ``EXACT_TOL`` 2e-3 between a gridded multiplier and the exact DTFT sum
  (`oracle/dtft`): the KB gridding's own error at the doubled geometry,
  5.8e-4 to 6.1e-4 here, far above float32's rounding (the port's and the
  oracle's gridded multipliers agree to 1.5e-6).
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from tron_tpu_torch import recon, solver
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.nufft import nufft_adjoint, sdc_weights
from tron_tpu_torch.oracle import toeplitz as oracle
from tron_tpu_torch.oracle.dtft import dtft2_adjoint
from tron_tpu_torch.trajectory import spoke_angles

NC, NRO, NPE1, WORK, SLIDE, NZ, NITER = 2, 64, 74, 25, 21, 3, 10
TOEPLITZ_TOL = 5e-5
WRAP_TOL = 1.5e-1
EXACT_TOL = 2e-3


def _cfg(**kw) -> ReconConfig:
    return ReconConfig(**{"adjoint": True, "golden_angle": True, "data_undersamp": 0.4,
                          "prof_slide": SLIDE, "niter": NITER, "toeplitz": True, **kw})


def _input(seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((2, NC, 1, NRO, NPE1), np.float32)
    return (x[0] + 1j * x[1]).astype(np.complex64)


def _rel(got, want) -> np.ndarray:
    """Each frame's relative L2 error; a frame that is not finite reads inf."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    dims = tuple(range(1, want.dim()))
    err = (torch.linalg.vector_norm(got - want, dim=dims)
           / torch.linalg.vector_norm(want, dim=dims)).numpy()
    return np.nan_to_num(err, nan=np.inf)


def _frames(indata: np.ndarray):
    """The frames' samples (F, C, work, nro) and angles (F, work)."""
    data = torch.from_numpy(indata[:, 0]).transpose(1, 2)
    d = torch.stack([data[:, z * SLIDE:z * SLIDE + WORK] for z in range(NZ)])
    a = torch.stack([spoke_angles(WORK, "golden", z * SLIDE) for z in range(NZ)])
    return d, a


def _series(indata: np.ndarray, quant: str = "float32", niter: int = NITER) -> torch.Tensor:
    return oracle.series(indata, list(range(NZ)), work=WORK, slide=SLIDE, kernwidth=2.0,
                         niter=niter, quant=quant)


@pytest.fixture
def card_route(monkeypatch):
    """The Toeplitz solve with the pair's right side, as a CUDA tensor
    resolves "auto" and "toeplitz" (`solver._resolve`)."""
    resolve = solver._resolve

    def on_the_card(operators, cfg, device):
        mode, toeplitz = resolve(operators, cfg, device)
        return ("pair" if toeplitz else mode), toeplitz

    monkeypatch.setattr(solver, "_resolve", on_the_card)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_solve_matches_the_oracle(card_route, seed):
    """`cgnr_radial2d` a frame at a time, float32, against the oracle's coil
    images of the same frames."""
    d, a = _frames(_input(seed))
    want, its = oracle.cgnr(d, a, 2.0, NITER)
    got = torch.stack([solver.cgnr_radial2d(d[z].contiguous(), a[z], _cfg()) for z in range(NZ)])
    assert got.shape == want.shape == (NZ, NC, NRO // 2, NRO // 2)
    assert its.tolist() == [NITER] * NZ
    assert _rel(got, want).max() < TOEPLITZ_TOL


@pytest.mark.parametrize("route,tol", [("card", TOEPLITZ_TOL), ("cpu", WRAP_TOL)])
def test_recon_matches_the_oracle(request, route, tol):
    """`recon_radial2d` with niter 10 and ``toeplitz``, host to host: on the
    card's route within ``TOEPLITZ_TOL``, on its own CPU route within the
    wrap's."""
    if route == "card":
        request.getfixturevalue("card_route")
    indata = _input(7)
    cfg = _cfg()
    assert cfg.frame_geometry(NRO, NPE1) == (WORK, SLIDE, NZ)
    got = recon.recon_radial2d(indata, cfg, device="cpu")[:, 0]
    assert got.shape == (NZ, NRO // 2, NRO // 2)
    err = _rel(got, _series(indata))
    assert err.max() < tol
    if route == "cpu":
        assert err.min() > TOEPLITZ_TOL      # the wrap shows: this is no rounding


def _exact(angles: torch.Tensor) -> torch.Tensor:
    """fft2(ifftshift(t)) of the exact sum t[d] = sum_m w_m exp(+2i pi k_m.d / nro)."""
    return solver.toeplitz_fourier_kernel(angles, _cfg(), NRO, method="exact")


@pytest.mark.parametrize("skip", [0, 20000])
def test_multiplier_matches_the_oracle_and_the_exact_sum(skip):
    """The port's gridded multiplier within float32's rounding of the
    oracle's; both within ``EXACT_TOL`` of the exact DTFT sum, and apart
    from it by the gridding's error."""
    a = torch.stack([spoke_angles(WORK, "golden", skip + SLIDE * z) for z in range(2)])
    want = oracle.multiplier(a, NRO, 2.0)
    got = torch.stack([solver.toeplitz_fourier_kernel(a[z], _cfg(), NRO) for z in range(2)])
    exact = torch.stack([_exact(a[z]) for z in range(2)])
    assert got.shape == want.shape == (2, NRO, NRO)
    assert _rel(got, want).max() < 1e-5
    for m in (got, want):
        err = _rel(m, exact)
        assert 1e-4 < err.min() and err.max() < EXACT_TOL


@pytest.mark.parametrize("seed", [1, 3])
def test_bfloat16_operands_and_an_iteration_fewer_fail_the_tolerance(seed):
    """The oracle with its gridding operands rounded to bfloat16 reads far
    outside ``TOEPLITZ_TOL``, and an iteration fewer further still."""
    indata = _input(seed)
    want = _series(indata)
    assert _rel(_series(indata, "bfloat16"), want).min() > 20 * TOEPLITZ_TOL
    assert _rel(_series(indata, niter=NITER - 1), want).min() > 1e-2


def _undoubled(monkeypatch):
    """The multiplier of the weights on the undoubled grid, applied as a
    circular convolution of the n x n image: offsets wrap, the circulant is
    indefinite, and CG leaves the frames not finite."""
    def kernel(angles, cfg, nro, **_):
        npe = int(angles.shape[0])
        w = solver._weights(cfg, nro, npe, angles.device).expand(npe, nro)
        t = nufft_adjoint(w.to(torch.complex64), angles, cfg, apply_sdc=False) * (nro * npe)
        return torch.fft.fft2(torch.fft.ifftshift(t, dim=(-2, -1)))

    monkeypatch.setattr(solver, "toeplitz_fourier_kernel", kernel)
    monkeypatch.setattr(solver, "toeplitz_apply",
                        lambda x, mult: torch.fft.ifft2(torch.fft.fft2(x) * mult).to(x.dtype))


def _scale_left_in(monkeypatch):
    """The gridder's 1/(nxos' npe) at the doubled geometry not undone."""
    kernel = solver.toeplitz_fourier_kernel
    monkeypatch.setattr(solver, "toeplitz_fourier_kernel", lambda angles, cfg, nro, **k:
                        kernel(angles, cfg, nro, **k) / (int(nro * cfg.gridos) * angles.shape[0]))


def _readout0_weighted(monkeypatch):
    """Readout 0 weighted into the multiplier: each spoke's sample at radius
    -nro/2 with its Ram-Lak weight (1, the largest), summed exactly.  The
    gridder never grids that radius, so it is added as the DTFT sum the
    multiplier approximates."""
    kernel = solver.toeplitz_fourier_kernel

    def with_readout0(angles, cfg, nro, **k):
        npe, r = int(angles.shape[0]), -nro / 2
        w0 = complex(sdc_weights(cfg, nro, npe, angles.device)[0])
        t0 = dtft2_adjoint(torch.full((npe,), w0), r * torch.cos(angles), r * torch.sin(angles),
                           nro, nro)
        return kernel(angles, cfg, nro, **k) + torch.fft.fft2(torch.fft.ifftshift(t0))

    monkeypatch.setattr(solver, "toeplitz_fourier_kernel", with_readout0)


FAULTS = [_undoubled, _scale_left_in, _readout0_weighted]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_planted_fault_reads_over_the_tolerance(card_route, monkeypatch, fault):
    """Each fault of the multiplier, planted in the port's card route, reads
    over ``TOEPLITZ_TOL`` against the oracle in every frame (they read inf,
    3.2e3 and 0.22-0.27)."""
    fault(monkeypatch)
    indata = _input(0)
    got = recon.recon_radial2d(indata, _cfg(), device="cpu")[:, 0]
    assert _rel(got, _series(indata)).min() > 1e3 * TOEPLITZ_TOL


@pytest.mark.parametrize("gridos,method", [(2.0, "nufft"), (1.5, "exact")])
def test_counts_one_build_a_frame(gridos, method):
    """`TOEPLITZ_COUNTS` counts one multiplier a frame, by the method it was
    built with: the gridded build at gridos 2, the exact sum elsewhere."""
    solver.reset_toeplitz_counts()
    recon.recon_radial2d(_input(4), _cfg(gridos=gridos, niter=2), device="cpu")
    assert solver.TOEPLITZ_COUNTS == {"nufft": 0, "exact": 0, method: NZ}
    solver.reset_toeplitz_counts()
    assert solver.TOEPLITZ_COUNTS == {"nufft": 0, "exact": 0}


def test_oracle_imports_none_of_the_port():
    """The oracle imports torch, numpy, the standard library and the plain
    CGNR reference beside it only, and turns TF32 off before it computes."""
    path = Path(oracle.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names <= {"__future__", "math", "numpy", "torch", "tron_tpu_torch.oracle.cgnr"}, names
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        oracle.series(_input(0), [0], work=WORK, slide=SLIDE, kernwidth=2.0, niter=1)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
