"""Start N ranks of a worker on one host and collect what they return.

    results = start_ranks("tron_tpu_torch.parallel.launch:run_calls", 4,
                          {"calls": [...]}, device="cpu")

Each rank is a fresh process (spawn) that imports `torch` and this package,
joins a world of N over a file store in a directory made for the run, calls
the named worker as ``worker(ctx, **payload)`` and writes its return value
(anything that pickles: numpy arrays, not tensors) for the parent.  On the
CPU a rank runs single-threaded over gloo.  On the card rank r takes
``cuda:(r % cards)``, with ``cards`` the visible cards unless the caller
names fewer: NCCL when every rank has a card of its own, gloo on CUDA
tensors when ranks share one.  The kernels are built once, here in the
parent, before the ranks start.

A rank that raises fails the start: the other ranks are stopped and the
error is raised here with the rank and its traceback.  So does a start that
outlasts ``timeout`` seconds; no rank is left behind either way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import pickle
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp


@dataclasses.dataclass(frozen=True)
class RankContext:
    rank: int
    world: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class RankResult:
    value: object           # what the worker returned
    launches: dict          # kernel launches in the rank, by kernel
    backend: str            # the collectives' backend ("gloo" / "nccl")
    device: str             # the rank's device
    imported: tuple         # which of "jax", "tron_tpu" the rank had imported


class RankError(RuntimeError):
    """A rank raised, exited or outlasted the time limit."""


def _resolve(worker: str):
    module, _, name = worker.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank: int, worker: str, nranks: int, rundir: str, device_type: str, cards: int,
               backend: str, timeout: float, payload: dict) -> None:
    from tron_tpu_torch.ops import degrid_cuda, grid_cuda
    from tron_tpu_torch.parallel import distributed

    if device_type == "cuda":
        device = torch.device("cuda", rank % cards)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    distributed.initialize(
        backend, device, timeout_s=timeout,
        init_method=f"file://{rundir}/store", rank=rank, world_size=nranks,
    )
    value = _resolve(worker)(RankContext(rank, nranks, device), **payload)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    result = RankResult(
        value,
        dict(grid_cuda.LAUNCH_COUNTS, degrid_radial2d=degrid_cuda.LAUNCHES),
        backend, str(device),
        tuple(m for m in ("jax", "tron_tpu") if m in sys.modules),
    )
    with open(Path(rundir) / f"result_{rank}.pkl", "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    distributed.shutdown()


def start_ranks(
    worker: str,
    nranks: int,
    payload: dict | None = None,
    *,
    device: str = "cuda",
    timeout: float = 300.0,
    cards: int | None = None,
) -> list[RankResult]:
    """Run ``worker`` ("module:function") in ``nranks`` ranks on ``device``
    ("cuda", the default, or "cpu") and return each rank's RankResult, in
    rank order.  ``cards``: spread the ranks over that many of the visible
    cards (default: all of them).  Raises RankError if a rank fails or the
    run outlasts ``timeout`` seconds."""
    if device == "cuda":
        from tron_tpu_torch import _build
        from tron_tpu_torch.device import resolve_device

        resolve_device()      # no card: raise here, not in N children
        _build.load()         # one build, which the ranks then find
        cards = min(cards or torch.cuda.device_count(), torch.cuda.device_count())
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = "nccl" if device == "cuda" and nranks <= cards else "gloo"
    rundir = tempfile.mkdtemp(prefix="tron_ranks_")
    ctx = mp.start_processes(
        _rank_main,
        args=(worker, nranks, rundir, device, cards, backend, timeout, payload or {}),
        nprocs=nranks, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic())), grace_period=1.0):
            if time.monotonic() >= deadline:
                raise RankError(f"{nranks} ranks of {worker} did not finish within {timeout:g} s")
        results = []
        for r in range(nranks):
            with open(Path(rundir) / f"result_{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    except mp.ProcessRaisedException as e:
        raise RankError(f"rank {e.error_index} of {worker} raised:\n{e.msg}") from None
    except mp.ProcessExitedException as e:
        raise RankError(f"rank {e.error_index} of {worker} exited with code {e.exit_code}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(rundir, ignore_errors=True)


# -- a worker that calls the sharded entry points ----------------------------

# entry points whose array arguments are tensors on the rank's device (the
# others take host arrays and compute on the mesh's device)
_TENSOR_ENTRIES = ("recon_frames_sharded", "recon_window_spoke_sharded")


def digest(a: np.ndarray) -> str:
    """A fingerprint of an array's shape, type and bits."""
    h = hashlib.sha1(f"{a.shape} {a.dtype} ".encode())
    h.update(np.ascontiguousarray(a).data)
    return h.hexdigest()


def run_calls(ctx: RankContext, calls: list, digests: bool = False) -> dict:
    """Worker: call sharded entry points of `tron_tpu_torch.parallel` by
    name, one after the other in one world, and return ``{"results": their
    results as numpy arrays, "seconds": each call's time in this rank}``
    (host clock, the device synchronised before and after; the first call of
    a kind also warms up).  A call is a dict: ``entry`` (the name), ``mesh`` ({axis:
    size} in mesh order, as ``dict(jax_mesh.shape)``), ``cfg`` (a
    ReconConfig), ``args`` (numpy arrays and numbers, after cfg and mesh in
    the entry's signature; the first one goes before them) and optional
    ``kwargs``.  With ``digests`` only rank 0 returns arrays and the other
    ranks ``digest`` of theirs: enough to show that every rank holds the
    whole result, without carrying it home from each."""
    from tron_tpu_torch import parallel
    from tron_tpu_torch.parallel.distributed import ProcessMesh

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    results, seconds = [], []
    for call in calls:
        mesh = ProcessMesh.from_jax(call["mesh"], ctx.device)
        first, *rest = call["args"]
        if call["entry"] in _TENSOR_ENTRIES:
            first = torch.from_numpy(np.ascontiguousarray(first)).to(ctx.device)
        sync()
        t0 = time.perf_counter()
        res = getattr(parallel, call["entry"])(first, call["cfg"], mesh, *rest, **call.get("kwargs", {}))
        sync()
        seconds.append(time.perf_counter() - t0)
        res = res.cpu().numpy() if isinstance(res, torch.Tensor) else res
        results.append(digest(res) if digests and ctx.rank else res)
    return {"results": results, "seconds": seconds}


def probe(ctx: RankContext, nz: int = 0, n_coil: int = 1, fail_rank: int | None = None,
          hang_rank: int | None = None) -> dict:
    """Worker: what a rank sees of its world.  Builds the global mesh, sums
    the ranks' numbers over the whole world (one all_reduce, so every rank
    must arrive) and returns the sum, the mesh's shape, this rank's
    coordinates and ``process_frame_slice(nz, n_coil)``.  ``fail_rank``
    raises in that rank before the collective and ``hang_rank`` keeps that
    rank away from it: the two ways a start can go wrong."""
    import torch.distributed as dist

    from tron_tpu_torch.parallel import distributed

    if ctx.rank == fail_rank:
        raise RuntimeError(f"probe: rank {ctx.rank} was asked to fail")
    if ctx.rank == hang_rank:
        time.sleep(3600)
    mesh = distributed.make_global_mesh(n_coil, ctx.device)
    total = torch.tensor([float(ctx.rank)], device=ctx.device)
    if ctx.world > 1:
        dist.all_reduce(total)
    sl = distributed.process_frame_slice(nz, n_coil)
    return {
        "sum": float(total), "shape": mesh.shape,
        "coords": {a.name: a.index for a in mesh.axes},
        "frames": (sl.start, sl.stop),
    }
