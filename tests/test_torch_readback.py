"""The in-memory recon's readback (`recon.readback_blocks`, the frame loops'
``sink``, `recon._RingPool`, ``recon.READBACK_COUNTS``).  On the card a
series comes back block by block while its frame loops run; the copy itself
needs the card (`tests/test_torch_cuda.py`).  Here, on the CPU: the block
plan, the blocks each frame loop hands its sink, the ring pool's lending
under threads, and the whole readback that the CPU and ``half_readback``
keep, at a tiny geometry: 3 coils, 64 readouts, frames of 25 spokes sliding
by 21."""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tron_tpu_torch import recon
from tron_tpu_torch.config import ReconConfig

torch.set_num_threads(1)

NC, NRO = 3, 64
FRAME_BYTES = (NRO // 2) ** 2 * 8  # one complex64 image of 32 x 32
MIB = 1 << 20


@pytest.mark.parametrize("nz,frame_bytes", [
    (1, 256 * 256 * 8),
    (31, 256 * 256 * 8),
    (32, 256 * 256 * 8),
    (33, 256 * 256 * 8),
    (956, 256 * 256 * 8),
    (918, 256 * 256 * 8 * 6),     # coils left uncombined
    (5, 16 * MIB),                # one frame a block, exactly
    (5, 16 * MIB + 8),            # a frame over the block's bytes
    (100, 3 * 1000 * 8),          # a block's bytes not a multiple of the frame's
])
def test_readback_blocks_cover_the_series_once(nz, frame_bytes):
    """The blocks cover [0, nz) once, in order, each at least one frame and
    at most 16 MiB unless one frame exceeds it; all but the last hold as
    many frames as fit."""
    blocks = recon.readback_blocks(nz, frame_bytes)
    bf = max(1, 16 * MIB // frame_bytes)
    assert blocks[0][0] == 0 and blocks[-1][1] == nz
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    for z0, z1 in blocks:
        assert 1 <= z1 - z0 <= bf
        assert (z1 - z0) * frame_bytes <= 16 * MIB or z1 - z0 == 1
    assert all(z1 - z0 == bf for z0, z1 in blocks[:-1])
    assert len(blocks) == -(-nz // bf)
    if frame_bytes == 256 * 256 * 8:
        assert bf == 32  # a whole-body frame: 956 frames in 30 blocks


def _samples(seed: int, nz: int) -> torch.Tensor:
    """(nc, npe1, nro) samples in the ops layout, for nz frames."""
    x = np.random.default_rng(seed).standard_normal((2, NC, 25 + 21 * (nz - 1), NRO))
    return torch.from_numpy((x[0] + 1j * x[1]).astype(np.complex64))


def _cfg(**kw) -> ReconConfig:
    return ReconConfig(adjoint=True, golden_angle=True, data_undersamp=0.4, prof_slide=21, **kw)


MODES = {"direct": ("recon_frames", {}),
         "incremental": ("recon_frames_incremental", {"incremental": True}),
         "cgnr": ("recon_frames", {"niter": 2})}


@pytest.mark.parametrize("nz", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_frame_loops_hand_each_block_to_the_sink(monkeypatch, mode, nz):
    """Each frame loop (`_map_frames`: the direct scheduler and the CGNR
    loop; `incremental_scan`) calls its sink once a block, in order, with
    the blocks of `readback_blocks` and its own output, whose frames of
    the block are written by then; the output is bitwise the loop's
    without a sink."""
    monkeypatch.setattr(recon, "READBACK_BLOCK_BYTES", 3 * FRAME_BYTES)
    name, kw = MODES[mode]
    frames_fn = getattr(recon, name)
    cfg = _cfg(**kw)
    data = _samples(nz, nz)
    work, slide, got_nz = cfg.frame_geometry(NRO, data.shape[1])
    assert (work, slide, got_nz) == (25, 21, nz)
    calls = []

    def sink(z0, z1, out):
        calls.append((z0, z1, out, out[z0:z1].clone()))

    out = frames_fn(data, cfg, work, slide, nz, sink=sink)
    assert [(z0, z1) for z0, z1, _, _ in calls] == recon.readback_blocks(nz, FRAME_BYTES)
    for z0, z1, held, block in calls:
        assert held is out
        assert torch.equal(block, out[z0:z1])
    assert torch.equal(out, frames_fn(data, cfg, work, slide, nz))


def _host_input(nt: int, nz: int) -> np.ndarray:
    """(nc, nt, nro, npe1) samples as a host array."""
    x = np.random.default_rng(nt + nz).standard_normal((2, NC, nt, NRO, 25 + 21 * (nz - 1)))
    return (x[0] + 1j * x[1]).astype(np.complex64)


@pytest.mark.parametrize("case", ["direct", "half", "nt2", "incremental", "cgnr", "nt2 half"])
def test_cpu_and_half_read_back_whole(case):
    """On the CPU (and with ``half_readback``) a series comes back in one
    copy after its last frame: ``whole`` counts one a series and ``blocks``
    none, and the images are the frame loops' outputs read back as before,
    (nz, nt, n, n)."""
    nt = 2 if "nt2" in case else 1
    half = "half" in case
    kw = {"incremental": {"incremental": True}, "cgnr": {"niter": 2}}.get(case, {})
    cfg = _cfg(**kw)
    nz = 4
    x = _host_input(nt, nz)
    recon.reset_readback_counts()
    got = recon.recon_radial2d(x, cfg, half_readback=half, device="cpu")
    again = recon.recon_radial2d(x, cfg, half_readback=half, device="cpu")
    assert recon.READBACK_COUNTS == {"blocks": 0, "whole": 2}

    frames_fn = recon.recon_frames_incremental if kw.get("incremental") else recon.recon_frames
    d = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 3, 2)))  # (nt, nc, npe1, nro)
    outs = torch.stack([frames_fn(d[t], cfg, 25, 21, nz) for t in range(nt)], dim=1)
    want = outs.numpy()
    if half:
        want = recon._from_half_planes(recon._to_half_planes(outs).numpy())
    assert got.shape == (nz, nt, NRO // 2, NRO // 2) and got.dtype == np.complex64
    assert got.flags.c_contiguous and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, got)
    assert not np.shares_memory(got, again)


def test_ring_pool_lends_each_ring_to_one_holder():
    """More threads than cores take and give back rings of two keys with a
    short switch interval: no ring is ever held by two threads at once, a
    ring given back is lent again, and no more rings are made than
    threads hold at once."""
    pool = recon._RingPool()
    nthreads = (os.cpu_count() or 1) + 2
    made = {"a": [], "b": []}
    held, lock, faults = set(), threading.Lock(), []

    def make(key):
        ring = object()
        with lock:
            made[key].append(ring)
        return ring

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            key = "ab"[int(rng.integers(2))]
            ring = pool.take(key, lambda: make(key))
            with lock:
                if id(ring) in held:
                    faults.append(ring)
                held.add(id(ring))
            time.sleep(0)
            with lock:
                held.discard(id(ring))
            pool.give(key, ring)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(nthreads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not faults
    assert 1 <= len(made["a"]) <= nthreads and 1 <= len(made["b"]) <= nthreads
    # every ring made is free again, and is what the next take lends
    for key in "ab":
        lent = {id(pool.take(key, lambda: None)) for _ in made[key]}
        assert lent == {id(r) for r in made[key]}
