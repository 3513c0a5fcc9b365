"""The plain references against the port's CPU route at a tiny geometry of
each traffic mix, and the references' own operators against the
definitions they implement."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import check, spec, traffic
from benchmark.reference import forward, nufft
from benchmark.reference.recon import Series


def test_reference_matches_the_port_on_the_cpu(tiny_root):
    """Every frame of a series through `recon_radial2d` (float32 on the
    CPU) within 1e-5 of the reference."""
    from benchmark.program import Program

    cell = spec.load_cell("tiny.adjoint", tiny_root)
    geo = traffic.geometry(cell)
    indata = traffic.make_input(geo, 12345, torch.device("cpu"))
    served = Program(cell.recon, cell.config["precision"], torch.device("cpu")).series(indata)
    ref = Series(indata, cell.recon, "cpu").frames(list(range(geo["nz"])))
    assert served.shape == tuple(ref.shape) == (3, 32, 32)
    assert check.frame_errors(served, ref).max() < 1e-5


def test_forward_reference_matches_the_port_on_the_cpu(tiny_root):
    """Every frame of a forward series (n 32, 2 coils, 3 frames) through
    `recon_radial2d` with ``adjoint`` false (float32 on the CPU, the plain
    gather) within 1e-5 of the reference.  The port computes the sample
    positions and KB weights in float32, the reference in float64: at a
    64-point grid a position differs by up to 32 * 2**-24 ~ 2e-6 of a grid
    step, and the sums run in another order, which reads ~1.4e-6."""
    from benchmark.program import Program

    cell = spec.load_cell("tiny.forward", tiny_root)
    geo = traffic.geometry(cell)
    indata = traffic.make_input(geo, 12345, torch.device("cpu"))
    assert indata.shape == (2, 1, 32, 32, 3) and indata.flags.f_contiguous
    served = Program(cell.recon, cell.config["precision"], torch.device("cpu")).series(indata)
    ref = spec.reference(cell).Series(indata, cell.recon, "cpu").frames(list(range(geo["nz"])))
    assert served.shape == tuple(ref.shape) == (3, 2, 25, 64)
    assert check.frame_errors(served, ref).max() < 1e-5


@pytest.mark.parametrize("n,npe,seed", [(16, 12, 0), (32, 25, 1)])
def test_forward_reference_is_the_direct_nudft(n, npe, seed):
    """The reference's samples against the type-2 NUDFT of the same images,
    sum over pixels (x, y), centred at n/2, of I[y, x] exp(-2 pi i (kx (x -
    n/2) + ky (y - n/2)) / nxos) at (kx, ky) = r (cos, sin) of each spoke's
    angle: within 2e-3, the KB interpolation's own error at gridos 2, kw 2
    (a 4-point window at twice oversampling reads 7.7e-4 to 8.2e-4 here)."""
    g = torch.Generator().manual_seed(seed)
    nxos, skip = 2 * n, 3
    # one frame of two coils, the reversed `.ra` dims (nz, ny, nx, 1, nc)
    indata = torch.randn((1, n, n, 1, 2), generator=g, dtype=torch.complex64).numpy()
    recon = {"adjoint": False, "golden_angle": True, "data_undersamp": npe / nxos,
             "gridos": 2.0, "kernwidth": 2.0, "skip_angles": skip}
    ref = forward.Series(indata.T, recon, "cpu")
    assert (ref.npe, ref.nro) == (npe, nxos)
    got = ref.frames([0])[0].to(torch.complex128)              # (C, npe, nro)
    img = torch.from_numpy(indata[0, :, :, 0]).permute(2, 0, 1).to(torch.complex128)  # [c, y, x]
    a = nufft.golden_angles(npe, skip).double()
    r = (torch.arange(nxos, dtype=torch.float64) / nxos - 0.5) * nxos
    p = torch.arange(n, dtype=torch.float64) - n // 2
    ex = torch.exp(-2j * math.pi * (r[None, :] * torch.cos(a)[:, None])[..., None] * p / nxos)
    ey = torch.exp(-2j * math.pi * (r[None, :] * torch.sin(a)[:, None])[..., None] * p / nxos)
    want = torch.einsum("cyx,prx,pry->cpr", img, ex, ey)
    err = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)
    assert err < 2e-3


def test_forward_rounding_reads_the_operands():
    """``quant`` rounds the gather's operands: bfloat16 reads ~1.6e-3 and
    float8 e4m3 ~2.4e-2 against float32 on the tiny geometry, wide apart."""
    g = torch.Generator().manual_seed(4)
    indata = torch.randn((3, 32, 32, 1, 2), generator=g, dtype=torch.complex64).numpy().T
    recon = {"adjoint": False, "golden_angle": True, "data_undersamp": 0.4, "gridos": 2.0,
             "kernwidth": 2.0, "skip_angles": 0}
    ref = forward.Series(indata, recon, "cpu")
    truth = ref.frames([0, 1, 2])
    bf16 = check.frame_errors(ref.frames([0, 1, 2], "bfloat16"), truth)
    fp8 = check.frame_errors(ref.frames([0, 1, 2], "float8_e4m3"), truth)
    assert (5e-4 < bf16).all() and (bf16 < 4e-3).all() and (fp8 > 5 * bf16.max()).all()


def test_gridding_is_the_direct_sum():
    """Each grid point holds the sum over samples of the sample times the
    KB weights of its x and y distances, taps off the grid dropped."""
    g = torch.Generator().manual_seed(0)
    n, npe, nro, kw = 16, 3, 12, 2.0
    a = nufft.golden_angles(npe, 5)
    radii = (torch.arange(nro, dtype=torch.float64) / nro - 0.5) * n
    y = torch.randn((1, 1, npe, nro), generator=g, dtype=torch.complex64)
    beta = nufft.kb_beta(kw)
    px = (radii[None, :] * torch.cos(a.double())[:, None]).flatten()
    py = (radii[None, :] * torch.sin(a.double())[:, None]).flatten()
    X = torch.arange(n, dtype=torch.float64) - n // 2
    wx = nufft.kb(px[:, None] - X[None, :], kw, beta)          # (samples, n)
    wy = nufft.kb(py[:, None] - X[None, :], kw, beta)
    want = torch.einsum("s,sy,sx->yx", y.flatten().to(torch.complex128),
                        wy.to(torch.complex128), wx.to(torch.complex128))
    got = nufft.grid(y, radii.float(), a[None], n, kw)[0, 0]
    assert torch.allclose(got.to(torch.complex128), want, rtol=0, atol=1e-5 * want.abs().max())


def test_kernel_and_angles_follow_their_definitions():
    """KB against scipy-free I0 by series, its Fourier transform at 0, and
    the golden angle of spoke 1."""
    d = torch.linspace(-2.5, 2.5, 101, dtype=torch.float64)
    beta = nufft.kb_beta(2.0)
    arg = beta * torch.sqrt(torch.clamp(1 - (d / 2) ** 2, min=0))
    i0 = sum((arg / 2) ** (2 * k) / float(math.factorial(k)) ** 2 for k in range(40))
    want = torch.where(d.abs() < 2, 0.25 * i0, torch.zeros_like(d))
    assert torch.allclose(nufft.kb(d, 2.0, beta), want, rtol=1e-6, atol=0)
    assert float(nufft.kb_hat(torch.zeros(1, dtype=torch.float64), 2.0, beta)) == pytest.approx(
        math.sinh(beta) / beta, rel=1e-12)
    assert float(nufft.golden_angles(2, 0)[1]) == pytest.approx(math.pi * 2 / (1 + 5 ** 0.5),
                                                                rel=1e-7)


def test_rounding_steps():
    x = torch.tensor([1.0 + 2 ** -9, 3.0, -448.0, 1e-3])
    assert nufft.rounding("float32")(x) is x
    assert nufft.rounding("bfloat16")(x)[0] == 1.0
    q = nufft.rounding("float8_e4m3")(x)
    assert q[2] == -448.0 and q[1] == 3.0 and abs(q[3] - 1e-3) > 1e-5
    with pytest.raises(ValueError):
        nufft.rounding("int4")


def test_reference_refuses_settings_it_does_not_work_out():
    indata = np.zeros((1, 1, 8, 8), np.complex64)
    recon = {"adjoint": True, "golden_angle": True, "data_undersamp": 1.0, "prof_slide": 0,
             "gridos": 2.0, "kernwidth": 2.0, "skip_angles": 0, "niter": 0}
    Series(indata, recon, "cpu")
    for bad in ({"toeplitz": True}, {"sdc": "ideal"}, {"golden_angle": False}):
        with pytest.raises(ValueError):
            Series(indata, {**recon, **bad}, "cpu")
    images = np.zeros((1, 1, 8, 8, 2), np.complex64)
    forward.Series(images, {**recon, "adjoint": False}, "cpu")
    for bad in ({"adjoint": True}, {"adjoint": False, "niter": 2}, {"adjoint": False, "sdc": "x"}):
        with pytest.raises(ValueError):
            forward.Series(images, {**recon, **bad}, "cpu")
    with pytest.raises(ValueError):
        forward.Series(np.zeros((1, 2, 8, 8, 2), np.complex64), {**recon, "adjoint": False}, "cpu")
