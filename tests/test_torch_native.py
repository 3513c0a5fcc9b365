"""The port's C++ .ra helper (`tron_tpu_torch/_native/ra_native.cpp`, bound
by `tron_tpu_torch/io/native.py`) vs its Python path and vs the JAX
package's helper (`tron_tpu.io.native`), on the same files.

Every route must give the same bytes: whole-file writes and reads, the
header query, the windowed profile reads of the streamed recon, region
writes and ``RaWriter``, and a ``tron-torch --stream`` run.  The float16
conversions are held to numpy bit for bit on ties, subnormals, infinities,
NaN and overflow.
"""

import functools

import numpy as np
import pytest
import torch

from tron_tpu.io import RaWriter as JRaWriter
from tron_tpu.io import native as jnative
from tron_tpu_torch import cli
from tron_tpu_torch.io import RaWriter, native
from tron_tpu_torch.io import ra as pyra

torch.set_num_threads(1)


def _array(kind, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((3, 2, 8, 20, 2)) + 1j * rng.standard_normal((3, 2, 8, 20, 2))
    return {
        "complex64": d.astype(np.complex64),
        "complex128": d[..., :1],
        "float32": d.real.astype(np.float32),
        "pair": np.stack([d.real, d.imag]).astype(np.float16),
        "int16": (100 * d.real).astype(np.int16)[0, 0],
        "uint8": np.arange(7, dtype=np.uint8),
    }[kind]


KINDS = ["complex64", "complex128", "float32", "pair", "int16", "uint8"]


@pytest.mark.parametrize("kind", KINDS)
def test_whole_file_routes_give_the_same_bytes(tmp_path, kind):
    """ra_write and ra_read through the port's helper, the Python path and
    JAX's helper; the helper's header query equals the Python one."""
    a = _array(kind)
    paths = {k: tmp_path / f"{k}.ra" for k in ("native", "python", "jax")}
    native.ra_write(a, paths["native"])
    pyra.ra_write(a, paths["python"])
    jnative.ra_write(a, paths["jax"])
    raw = paths["python"].read_bytes()
    assert paths["native"].read_bytes() == raw and paths["jax"].read_bytes() == raw
    assert native.ra_query(paths["python"]) == pyra.ra_query(paths["python"])
    for order in ("F", "C"):
        got = native.ra_read(paths["python"], order=order)
        want = pyra.ra_read(paths["python"], order=order)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jnative.ra_read(paths["python"], order=order))
    relabel = (a.size,)
    native.ra_write(a, paths["native"], dims=relabel)
    pyra.ra_write(a, paths["python"], dims=relabel)
    assert paths["native"].read_bytes() == paths["python"].read_bytes()


def test_big_endian_and_bad_files(tmp_path):
    """The helper refuses the big-endian flag, so such a file is read by the
    Python reader (byte-swapped), as in the JAX package; a bad magic and a
    missing file raise."""
    a = _array("float32")[0, 0]
    head = np.array([pyra.RA_MAGIC, pyra.RA_FLAG_BIG_ENDIAN, pyra.RA_TYPE_FLOAT, 4, a.nbytes,
                     a.ndim, *a.shape], dtype="<u8")
    p = tmp_path / "be.ra"
    p.write_bytes(head.tobytes() + np.asfortranarray(a).astype(">f4").tobytes(order="F"))
    with pytest.warns(UserWarning, match="big-endian"):
        np.testing.assert_array_equal(native.ra_read(p), a)
    with pytest.warns(UserWarning, match="big-endian"):
        assert native.ra_query(p).flags == pyra.RA_FLAG_BIG_ENDIAN
    bad = tmp_path / "bad.ra"
    bad.write_bytes(b"\x01" * 64)
    for fn in (native.ra_read, native.ra_query):
        with pytest.raises(IOError, match="bad magic"):
            fn(bad)
    with pytest.raises(IOError, match="I/O error"):
        native.ra_read(tmp_path / "missing.ra")


@pytest.mark.parametrize("stack", [False, True], ids=["2d", "stack"])
@pytest.mark.parametrize("kind", ["complex64", "float32", "pair"])
def test_profile_windows_match_python_and_jax(tmp_path, kind, stack):
    """The streamed recon's windowed reads (ra_read_profiles, one region;
    ra_read_profiles_stack, one region per kz encoding) through the helper
    and through Python seeks and reads, vs JAX's reader."""
    p = tmp_path / "d.ra"
    pyra.ra_write(_array(kind, 7), p)
    fn = native.ra_read_profiles_stack if stack else native.ra_read_profiles
    jfn = jnative.ra_read_profiles_stack if stack else jnative.ra_read_profiles
    calls = native.CALLS["read_region"]
    got = fn(p, 5, 9)
    assert native.CALLS["read_region"] == calls + (2 if stack else 1)
    want = fn(p, 5, 9, native=False)
    assert native.CALLS["read_region"] == calls + (2 if stack else 1)
    assert got.shape == want.shape and got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jfn(p, 5, 9))
    for nat in (True, False):
        with pytest.raises(ValueError, match="outside"):
            fn(p, 15, 9, native=nat)


@pytest.mark.parametrize("nat", [True, False], ids=["native", "python"])
def test_region_writes_match_python(tmp_path, nat):
    """ra_write_region lands the same bytes through the helper and through
    os.pwrite; a region past the payload raises either way."""
    a = _array("complex64", 3)
    p, ref = tmp_path / "p.ra", tmp_path / "ref.ra"
    for q in (p, ref):
        pyra.ra_write(np.zeros_like(a), q)
    flat = np.asfortranarray(a).reshape(-1, order="F")
    calls = native.CALLS["write_region"]
    native.ra_write_region(p, 8 * 40, flat[40:100], native=nat)
    native.ra_write_region(p, 0, flat[:40], native=nat)
    assert native.CALLS["write_region"] == calls + (2 if nat else 0)
    jnative.ra_write_region(ref, 8 * 40, flat[40:100])
    jnative.ra_write_region(ref, 0, flat[:40])
    assert p.read_bytes() == ref.read_bytes()
    with pytest.raises(ValueError):
        native.ra_write_region(p, a.nbytes - 8, flat[:2], native=nat)
    with pytest.raises(ValueError):
        native.ra_write_region(p, -8, flat[:1], native=nat)


def test_ra_writer_routes_give_the_same_bytes(tmp_path):
    """RaWriter through the helper and through os.pwrite, and JAX's, landing
    regions out of order."""
    rng = np.random.default_rng(8)
    frames = (rng.standard_normal((4, 6)) + 1j * rng.standard_normal((4, 6))).astype(np.complex64)
    for make, name in ((RaWriter, "native.ra"),
                       (functools.partial(RaWriter, native=False), "python.ra"),
                       (JRaWriter, "jax.ra")):
        with make(tmp_path / name, (2, 3, 4), np.complex64) as w:
            w.write_at(12, frames[2:])
            w.write_at(0, frames[:2])
    raw = (tmp_path / "python.ra").read_bytes()
    assert (tmp_path / "native.ra").read_bytes() == raw == (tmp_path / "jax.ra").read_bytes()


def _special_f32() -> np.ndarray:
    """Ties at every rounding position, subnormal and underflowing halves,
    the overflow edge, infinities, NaN and signed zeros."""
    rng = np.random.default_rng(5)
    mant = rng.integers(0, 1 << 10, 2000, dtype=np.uint32)
    expo = rng.integers(127 - 28, 127 + 17, 2000, dtype=np.uint32)
    ties = (expo << 23) | (mant << 13) | (1 << 12)                     # exactly half an ulp
    near = ties + rng.integers(-2, 3, 2000).astype(np.uint32)
    bits = np.concatenate([ties, near, ties | (1 << 31)]).view(np.float32)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 65504.0, 65519.996,
                      65520.0, 1e9, -1e9, 2.0**-14, 2.0**-24, 2.0**-25, 1.5 * 2.0**-25,
                      2.0**-26, 6.1e-5, -3e-8, 1e-40], dtype=np.float32)
    subnormal_ties = (np.arange(1, 2048, 2) * 2.0**-25).astype(np.float32)  # half a 2^-24
    scaled = (rng.standard_normal(4000) * 10.0 ** rng.integers(-9, 6, 4000)).astype(np.float32)
    return np.concatenate([bits, edges, subnormal_ties, -subnormal_ties, scaled])


def test_half_conversions_match_numpy_and_jax():
    x = _special_f32()
    with np.errstate(over="ignore"):
        want = x.astype(np.float16)
    got = native.f32_to_f16(x)
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    np.testing.assert_array_equal(got.view(np.uint16), jnative.f32_to_f16(x).view(np.uint16))
    every = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    back = native.f16_to_f32(every)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back.view(np.uint32), every.astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(back.view(np.uint32), jnative.f16_to_f32(every).view(np.uint32))


def test_build_is_keyed_by_the_source(tmp_path, monkeypatch):
    """The library is named by a hash of its source and flags, so another
    source builds beside it; a source that does not compile raises with the
    compiler's output."""
    lib = native.ensure_native()
    built = sorted(p.name for p in native._build.BUILD_DIR.glob("libra_native_*.so"))
    assert built and native.available() and lib is native.ensure_native()
    src = tmp_path / "ra_native.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native._build, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.ensure_native()
        assert not native.available()
        assert not list((tmp_path / "build").glob("*"))  # no half-built file left
    finally:
        native._load.cache_clear()


@pytest.mark.parametrize("extra", [[], ["--half"]], ids=["complex", "half"])
def test_cli_stream_file_is_the_same_through_the_helper(tmp_path, monkeypatch, extra):
    """tron-torch --stream reads its windows and writes its regions through
    the helper; forced onto the Python path it writes the same file."""
    monkeypatch.setattr(cli, "resolve_device", lambda index: torch.device("cpu"))
    rng = np.random.default_rng(2)
    d = rng.standard_normal((2, 1, 32, 72, 1)) + 1j * rng.standard_normal((2, 1, 32, 72, 1))
    src = tmp_path / "d.ra"
    pyra.ra_write(d.astype(np.complex64), src)
    args = ["-a", "-G", "-u", "0.5", "-d", "4", "--stream", *extra, str(src)]
    before = dict(native.CALLS)
    assert cli.main(args + [str(tmp_path / "native.ra")]) == 0
    assert all(native.CALLS[k] > before[k] for k in before)
    before = dict(native.CALLS)
    with monkeypatch.context() as m:
        for name in ("ra_read_profiles", "ra_write_region"):
            fn = getattr(native, name)
            m.setattr(native, name, lambda *a, fn=fn, **k: fn(*a, **{**k, "native": False}))
        assert cli.main(args + [str(tmp_path / "python.ra")]) == 0
    assert native.CALLS == before
    assert (tmp_path / "native.ra").read_bytes() == (tmp_path / "python.ra").read_bytes()
