"""Process meshes and collectives on `torch.distributed` (counterpart of
`tron_tpu/parallel/distributed.py`, and of the `jax.sharding.Mesh` the JAX
package shards over).

JAX runs one program over a device mesh; here one process drives one device
and every sharded entry point is called by every rank.  A ``ProcessMesh``
names this rank's place: per axis its size, this rank's coordinate and the
process group of the ranks that differ only in that coordinate.  Rank ``r``
of an (n_frame, n_coil) mesh sits at ``(r // n_coil, r % n_coil)``, the
row-major ``devices.reshape(n_frame, n_coil)`` of the JAX mesh, so a coil
group is a run of consecutive ranks and stays inside a host (its all_reduce
and all_gather ride NVLink) while the frame axis, which never communicates
before the final gather, spans hosts.

A world of 1 needs no process group: an axis of size 1 has no group, and
every collective on it is the identity.

    torchrun --nproc-per-node 4 -m tron_tpu_torch.cli -a -G --shard in.ra out.ra

or, in a program every rank runs:

    from tron_tpu_torch.parallel import distributed, recon_frames_sharded
    distributed.initialize()            # RANK, WORLD_SIZE, MASTER_ADDR from the environment
    mesh = distributed.make_global_mesh(n_coil=2)
    out = recon_frames_sharded(data, cfg, mesh, work, slide, nz)

Collectives run on NCCL for CUDA tensors and gloo for CPU tensors.  Ranks
that share one card cannot use NCCL; they run gloo on CUDA tensors, where
all_reduce works and all_gather does not, so ``all_gather_cat`` stages that
one case through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a ProcessMesh as this rank sees it."""

    name: str
    size: int = 1
    index: int = 0                 # this rank's coordinate along the axis
    group: object | None = None    # the ProcessGroup along the axis; None at size 1


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """Axis names and sizes, this rank's coordinates, one process group per
    axis, and the device this rank computes on."""

    axes: tuple[MeshAxis, ...]
    device: torch.device  # where this rank computes

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return {a.name: a.size for a in self.axes}

    @property
    def size(self) -> int:
        return math.prod(a.size for a in self.axes)

    def axis(self, name: str) -> MeshAxis:
        """The named axis; an axis the mesh does not have is one of size 1
        (a ('spoke',) mesh has a trivial 'coil' axis)."""
        for a in self.axes:
            if a.name == name:
                return a
        return MeshAxis(name)

    @classmethod
    def create(cls, names, sizes, device=None) -> "ProcessMesh":
        """The row-major mesh of ``sizes`` over all ranks of the world.
        Every rank must call this, with the same arguments in the same
        order: process groups are created collectively."""
        names, sizes = tuple(names), tuple(int(s) for s in sizes)
        world = world_size()
        if len(names) != len(sizes) or math.prod(sizes) != world:
            raise ValueError(f"mesh {dict(zip(names, sizes))} does not cover a world of {world} rank(s)")
        device = torch.device(device) if device is not None else default_device()
        coords = _unravel(rank(), sizes)
        axes = tuple(
            MeshAxis(name, size, coords[k], _axis_group(sizes, k, coords))
            for k, (name, size) in enumerate(zip(names, sizes))
        )
        return cls(axes, device)

    @classmethod
    def from_jax(cls, shape: dict, device=None) -> "ProcessMesh":
        """The mesh with the axis names and sizes of a ``jax.sharding.Mesh``,
        given as ``dict(mesh.shape)`` (a plain dict in mesh order, so that no
        JAX object crosses packages); beside ``ReconConfig.from_jax_fields``."""
        return cls.create(tuple(shape), tuple(shape.values()), device)


def _unravel(r: int, sizes) -> tuple[int, ...]:
    coords = []
    for s in reversed(sizes):
        coords.append(r % s)
        r //= s
    return tuple(reversed(coords))


def _axis_group(sizes, k: int, coords):
    """The group of the ranks that differ from this one only along axis k.
    Every rank creates every line's group, in one order, and keeps its own."""
    if sizes[k] == 1:
        return None
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    mine = None
    others = [range(s) for i, s in enumerate(sizes) if i != k]
    for rest in itertools.product(*others):
        fixed = list(rest[:k]) + [0] + list(rest[k:])
        base = sum(c * st for c, st in zip(fixed, strides))
        group = dist.new_group([base + j * strides[k] for j in range(sizes[k])])
        if all(fixed[i] == coords[i] for i in range(len(sizes)) if i != k):
            mine = group
    return mine


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def default_device() -> torch.device:
    """The card this process has made current (``initialize`` does, for a
    CUDA device); never the CPU, which a caller names itself."""
    from tron_tpu_torch.device import resolve_device

    return resolve_device(torch.cuda.current_device() if torch.cuda.is_available() else 0)


def initialize(backend: str | None = None, device=None, timeout_s: float = 1800.0, **kwargs) -> None:
    """``torch.distributed.init_process_group`` passthrough.  Idempotent.

    ``device`` is the device this rank computes on (default: ``cuda:LOCAL_RANK``
    under torchrun, else the card).  ``backend`` defaults by its type: NCCL
    for a card of this rank's own, gloo for the CPU and for ranks that share
    a card (more local ranks than cards).  ``kwargs`` (``init_method`` such
    as ``file:///path`` or ``tcp://host:port``, ``rank``, ``world_size``)
    go through; without them the rendezvous is read from the environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as torchrun sets it.  A
    collective that waits longer than ``timeout_s`` raises."""
    if dist.is_initialized():
        return
    if device is None:
        from tron_tpu_torch.device import resolve_device

        device = resolve_device(int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", kwargs.get("world_size", 1)))
        own_card = device.type == "cuda" and local <= torch.cuda.device_count()
        backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def shutdown() -> None:
    """Leave the world (every rank calls it); the meshes made in it go with
    its process groups."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_global_mesh(n_coil: int = 1, device=None) -> ProcessMesh:
    """('frame', 'coil') mesh over all ranks of all hosts.  Ranks are
    contiguous per host, so 'frame' splits across hosts (no collective
    crosses a host before the final gather) while each host's ranks fill
    whole coil groups: ``n_coil`` must divide the ranks per host
    (LOCAL_WORLD_SIZE; the world when there is one host)."""
    world = world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_coil > 1 and local % n_coil:
        raise ValueError(
            f"n_coil={n_coil} must divide the ranks per host ({local}) so that coil "
            "collectives stay inside a host"
        )
    return ProcessMesh.create(("frame", "coil"), (world // n_coil, n_coil), device)


def frame_slice(nz: int, n_frame: int, fid: int) -> slice:
    """The frames of frame coordinate ``fid``: per = ceil(nz / n_frame)
    consecutive frames each, the last coordinates taking what is left."""
    per = -(-nz // n_frame)
    return slice(min(fid * per, nz), min((fid + 1) * per, nz))


def process_frame_slice(nz: int, n_coil: int = 1) -> slice:
    """The frames this process owns under ``make_global_mesh``, for reading
    only its own profile windows (``io.native.ra_read_profiles``).  A
    process drives one device here, so this is the slice of its frame
    coordinate ``rank // n_coil``: the JAX package's arithmetic
    (`tron_tpu/parallel/distributed.py:60-74`) with one frame-device per
    process, and the partition ``recon_frames_sharded`` uses."""
    return frame_slice(nz, world_size() // n_coil, rank() // n_coil)


def psum(x: torch.Tensor, axis: MeshAxis | None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``jax.lax.psum``), the same
    bits on each of them; ``x`` itself on an axis of size 1."""
    if axis is None or axis.size == 1:
        return x
    buf = x.clone(memory_format=torch.contiguous_format)
    flat = torch.view_as_real(buf) if buf.is_complex() else buf
    dist.all_reduce(flat.reshape(-1), group=axis.group)
    return buf


def all_gather_cat(x: torch.Tensor, axis: MeshAxis | None, dim: int = 0) -> torch.Tensor:
    """The shards of the ranks of ``axis``, in coordinate order, joined along
    ``dim``; ``x`` itself on an axis of size 1.  Every rank gives one shape."""
    if axis is None or axis.size == 1:
        return x
    src = x.contiguous()
    if src.is_cuda and dist.get_backend(axis.group) == "gloo":
        src = src.cpu()  # gloo gathers no CUDA tensors: ranks that share a card
    flat = torch.view_as_real(src) if src.is_complex() else src
    parts = [torch.empty_like(flat) for _ in range(axis.size)]
    dist.all_gather(parts, flat, group=axis.group)
    if src.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    return torch.cat(parts, dim=dim).to(x.device)
