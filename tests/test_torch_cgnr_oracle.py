"""The port's CGNR recon (`tron -i N`) against its plain reference,
`tron_tpu_torch/oracle/cgnr.py`, on the CPU at a small geometry: 2 coils,
64 readouts, 74 spokes, frames of 25 spokes sliding by 21 (3 frames), 10
iterations, seeded complex Gaussian samples.

Tolerances, relative L2 per frame:

- ``PAIR_TOL`` 5e-5, the kernel pair (what the card runs; here the
  kernels' plain versions at float32): the port and the oracle compute one
  operator in float32, the port with KB weights and positions in float32,
  the oracle in float64, and both sum in other orders over 21 operator
  applications a frame; they read 2e-6 to 5e-6.  The oracle with its
  operands rounded to bfloat16, the precision the card computes, reads
  4e-3 to 1e-2 and fails it.
- ``WRAP_TOL`` 6e-2, ``recon_radial2d`` on its CPU route: there "auto"
  takes the autograd transpose of the plain forward, which wraps KB
  footprints at the grid's edge (the JAX package's CPU route) where the
  pair and the oracle clip them; the highest-|k| readouts, which Ram-Lak
  weights most, differ, and the frames read 2.3e-2 to 2.9e-2.
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from tron_tpu_torch import recon, solver
from tron_tpu_torch.config import ReconConfig
from tron_tpu_torch.oracle import cgnr as oracle
from tron_tpu_torch.trajectory import spoke_angles

NC, NRO, NPE1, WORK, SLIDE, NZ, NITER = 2, 64, 74, 25, 21, 3, 10
PAIR_TOL = 5e-5
WRAP_TOL = 6e-2


def _cfg() -> ReconConfig:
    return ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=SLIDE,
                       niter=NITER)


def _input(seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((2, NC, 1, NRO, NPE1), np.float32)
    return (x[0] + 1j * x[1]).astype(np.complex64)


def _rel(got, want) -> np.ndarray:
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    dims = tuple(range(1, want.dim()))
    return (torch.linalg.vector_norm(got - want, dim=dims)
            / torch.linalg.vector_norm(want, dim=dims)).numpy()


def _frames(indata: np.ndarray):
    """The frames' samples (F, C, work, nro) and angles (F, work)."""
    data = torch.from_numpy(indata[:, 0]).transpose(1, 2)
    d = torch.stack([data[:, z * SLIDE:z * SLIDE + WORK] for z in range(NZ)])
    a = torch.stack([spoke_angles(WORK, "golden", z * SLIDE) for z in range(NZ)])
    return d, a


def _series(indata: np.ndarray, quant: str = "float32") -> torch.Tensor:
    return oracle.series(indata, list(range(NZ)), work=WORK, slide=SLIDE, kernwidth=2.0,
                         niter=NITER, quant=quant)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_pair_matches_the_oracle(seed):
    """`cgnr_radial2d(operators="pair")` a frame at a time, float32, against
    the oracle's coil images of the same frames."""
    d, a = _frames(_input(seed))
    want, its = oracle.cgnr(d, a, 2.0, NITER)
    got = torch.stack([solver.cgnr_radial2d(d[z].contiguous(), a[z], _cfg(), operators="pair")
                       for z in range(NZ)])
    assert got.shape == want.shape == (NZ, NC, NRO // 2, NRO // 2)
    assert its.tolist() == [NITER] * NZ
    assert _rel(got, want).max() < PAIR_TOL


@pytest.mark.parametrize("operators,tol", [("pair", PAIR_TOL), ("auto", WRAP_TOL)])
def test_recon_matches_the_oracle(monkeypatch, operators, tol):
    """`recon_radial2d` with niter 10, host to host: with the card's
    operators (the pair, here through the plain versions) within the
    pair's tolerance, and on its own CPU route within the wrap's."""
    if operators == "pair":
        monkeypatch.setattr(recon, "cgnr_radial2d",
                            functools.partial(solver.cgnr_radial2d, operators="pair"))
    indata = _input(7)
    cfg = _cfg()
    assert cfg.frame_geometry(NRO, NPE1) == (WORK, SLIDE, NZ)
    got = recon.recon_radial2d(indata, cfg, device="cpu")[:, 0]
    assert got.shape == (NZ, NRO // 2, NRO // 2)
    err = _rel(got, _series(indata))
    assert err.max() < tol
    if operators == "auto":
        assert err.min() > PAIR_TOL      # the wrap shows: this is no rounding


@pytest.mark.parametrize("seed", [1, 3])
def test_bfloat16_operands_fail_the_pair_tolerance(seed):
    """The oracle with its gridding and degridding operands rounded to
    bfloat16 reads far outside ``PAIR_TOL``, and an iteration fewer
    further still: the tolerance tells both from float32."""
    indata = _input(seed)
    want = _series(indata)
    assert _rel(_series(indata, "bfloat16"), want).min() > 20 * PAIR_TOL
    fewer = oracle.series(indata, list(range(NZ)), work=WORK, slide=SLIDE, kernwidth=2.0,
                          niter=NITER - 1)
    assert _rel(fewer, want).min() > 1e-2


@pytest.mark.parametrize("skip", [0, 20000])
def test_oracle_forward_is_the_transpose_of_its_adjoint(skip):
    """<A x, y> = <x, A^H y> on random images and samples, within float32's
    rounding of the sums (they read ~1e-7)."""
    g = torch.Generator().manual_seed(9)
    a = torch.stack([oracle.golden_angles(WORK, skip + 21 * z) for z in range(2)])
    ops = oracle.Frames(a, NRO, 2.0)
    x = torch.randn((2, NC, NRO // 2, NRO // 2), generator=g, dtype=torch.complex64)
    y = torch.randn((2, NC, WORK, NRO), generator=g, dtype=torch.complex64)
    fx = ops.forward(x)
    assert fx.shape == y.shape and (fx[..., 0] == 0).all()
    lhs = torch.vdot(fx.flatten().to(torch.complex128), y.flatten().to(torch.complex128))
    rhs = torch.vdot(x.flatten().to(torch.complex128),
                     ops.adjoint(y).flatten().to(torch.complex128))
    assert abs(lhs - rhs) / abs(lhs) < 1e-6


def test_counts_ten_iterations_a_frame():
    """A recon of 3 frames at niter 10 runs 3 solves of 10 iterations: on
    Gaussian data the rtol stop never ends a solve early."""
    solver.reset_cgnr_counts()
    recon.recon_radial2d(_input(4), _cfg(), device="cpu")
    assert solver.cgnr_counts() == {"solves": NZ, "iterations": NZ * NITER}
    solver.reset_cgnr_counts()
    assert solver.cgnr_counts() == {"solves": 0, "iterations": 0}


def test_counts_an_early_stop():
    """A solve whose right side is zero stops before its first iteration."""
    solver.reset_cgnr_counts()
    d = torch.zeros((NC, WORK, NRO), dtype=torch.complex64)
    x = solver.cgnr_radial2d(d, spoke_angles(WORK, "golden", 0), _cfg())
    assert not x.any()
    assert solver.cgnr_counts() == {"solves": 1, "iterations": 0}


def test_oracle_imports_none_of_the_port():
    """The oracle imports torch, numpy and the standard library only, and
    turns TF32 off before it computes."""
    path = Path(oracle.__file__)
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}, names
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        oracle.series(_input(0), [0], work=WORK, slide=SLIDE, kernwidth=2.0, niter=1)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
