"""The in-memory recon's input path (`recon._upload`, `recon._relaid`): the
host array goes to the device in the memory order it has and is relaid
there.  Every output is held bitwise to the former host relayout (a numpy
transpose into the ops layout, then the copy), whatever the input's order,
dtype or strides; ``recon.UPLOAD_COUNTS`` says which inputs took a host
copy.  On the CPU at a tiny geometry: 3 coils, 64 readouts, 74 spokes,
frames of 25 spokes sliding by 21, so 3 frames."""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from tron_tpu_torch import recon
from tron_tpu_torch.config import ReconConfig

torch.set_num_threads(1)

NC, NRO, NPE1, NZ = 3, 64, 74, 3


def _host_relaid(arr, device, dims):
    """The former host relayout: a numpy transpose into the wanted order as
    one C-contiguous complex64 copy, then the copy to the device."""
    return torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(arr), dims), dtype=np.complex64)
    ).to(device)


def _former_path(monkeypatch):
    """Route the recon through the former host relayout: the upload hands
    the host array on untouched, and the relayout transposes it on the host
    and copies the result to the device."""
    monkeypatch.setattr(recon, "_upload", lambda arr, device: (arr, device))
    monkeypatch.setattr(recon, "_relaid", lambda host, dims: _host_relaid(*host, dims))


def _complex(seed, shape, dtype=np.complex64):
    x = np.random.default_rng(seed).standard_normal((2,) + shape)
    return (x[0] + 1j * x[1]).astype(dtype)


def _samples(kind: str) -> np.ndarray:
    """(nc, nt, nro, npe1[, npe2]) samples in the memory layout ``kind``
    names."""
    if kind == "C nt2":
        return _complex(2, (NC, 2, NRO, NPE1))
    x = _complex(1, (NC, 1, NRO, NPE1))
    if kind == "C":
        return x
    if kind == "F":
        return np.asfortranarray(x)
    if kind == "F npe2":
        return np.asfortranarray(_complex(3, (NC, 1, NRO, NPE1, 2)))
    if kind == "C npe2":
        return _complex(3, (NC, 1, NRO, NPE1, 2))
    if kind == "complex128":
        return x.astype(np.complex128)
    if kind == "view":
        # every other readout of a wider acquisition: strided in both orders
        return _complex(4, (NC, 1, 2 * NRO, NPE1))[:, :, ::2]
    raise ValueError(kind)


# input -> the upload count it adds
KINDS = {"C": "as_is", "C nt2": "as_is", "F": "as_is", "F npe2": "as_is",
         "C npe2": "host_copy", "complex128": "host_copy", "view": "host_copy"}
MODES = {"direct": {}, "incremental": {"incremental": True},
         "compress": {"coil_compress": 2}, "cgnr": {"niter": 3}}


def _cfg(**kw) -> ReconConfig:
    return ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21, **kw)


def _first_kz(x: np.ndarray) -> np.ndarray:
    """The samples the in-memory adjoint takes: a trailing npe2 axis's
    first plane, as a view."""
    return x.reshape(*x.shape[:4], -1)[..., 0]


def _counted(fn):
    recon.reset_upload_counts()
    out = fn()
    return out, dict(recon.UPLOAD_COUNTS)


@pytest.mark.parametrize("kind", list(KINDS))
def test_upload_relaid_is_the_host_relayout(kind):
    """The ops-layout tensor: the former host relayout's shape, strides,
    dtype and bits, a fresh tensor even where the input is already in that
    order."""
    x = _samples(kind)
    view = _first_kz(x)
    got, counts = _counted(lambda: recon._relaid(recon._upload(view, "cpu"), (1, 0, 3, 2)))
    want = _host_relaid(view, "cpu", (1, 0, 3, 2))
    assert counts == {"as_is": 0, "host_copy": 0, KINDS[kind]: 1}
    assert got.dtype == want.dtype == torch.complex64
    assert got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(got, want)
    assert not np.shares_memory(got.numpy(), x)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_recon_is_bitwise_the_host_relayout(monkeypatch, kind, mode):
    """recon_radial2d's images, direct, incremental, coil-compressed and by
    CGNR, are bitwise those of the former host relayout, for every input
    layout; the input is left as it was."""
    x = _samples(kind)
    before = x.copy()
    cfg = _cfg(**MODES[mode])
    assert cfg.frame_geometry(NRO, NPE1) == (25, 21, NZ)
    got, counts = _counted(lambda: recon.recon_radial2d(x, cfg, device="cpu"))
    assert counts == {"as_is": 0, "host_copy": 0, KINDS[kind]: 1}
    _former_path(monkeypatch)
    want = recon.recon_radial2d(x, cfg, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape == (NZ, x.shape[1], 32, 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(x, before)


@pytest.mark.parametrize("order", ["C", "F"])
def test_forward_is_bitwise_the_host_relayout(monkeypatch, order):
    """The forward's samples from images (nc, nt, nx, ny, nz) in either
    order: bitwise those of the former host relayout, uploaded as they
    are."""
    imgs = _complex(5, (2, 1, 16, 16, 3))
    if order == "F":
        imgs = np.asfortranarray(imgs)
    cfg = ReconConfig(adjoint=False, golden_angle=True, data_undersamp=1.0)
    got, counts = _counted(lambda: recon.recon_radial2d(imgs, cfg, device="cpu"))
    assert counts == {"as_is": 1, "host_copy": 0}
    _former_path(monkeypatch)
    want = recon.recon_radial2d(imgs, cfg, device="cpu")
    assert got.shape == want.shape == (3, 2, 1, 32, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_upload_counts_and_keeps_values(kind):
    """`_upload`: the array's shape and values as complex64, counted
    ``as_is`` for a C- or Fortran-contiguous complex64 array and
    ``host_copy`` otherwise; a read-only array goes up without a warning."""
    x = _first_kz(_samples(kind))
    x.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, counts = _counted(lambda: recon._upload(x, "cpu"))
    assert counts == {"as_is": 0, "host_copy": 0, KINDS[kind]: 1}
    assert got.shape == x.shape and got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), x.astype(np.complex64))
    recon.reset_upload_counts()
    assert recon.UPLOAD_COUNTS == {"as_is": 0, "host_copy": 0}


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_upload_then_one_relayout(kind):
    """Whatever the input, the adjoint records one ``tron.upload`` (the
    copy, after any host copy) and then one ``tron.relayout`` (the permute
    on the device)."""
    x = _samples(kind)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        recon.recon_radial2d(x, _cfg(), device="cpu")
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name in ("tron.upload", "tron.relayout"))
    assert [n for _, _, n in spans] == ["tron.upload", "tron.relayout"]
    assert spans[0][1] <= spans[1][0], spans
