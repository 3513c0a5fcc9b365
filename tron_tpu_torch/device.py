"""Device selection (counterpart of the CLI's `-g` handling in
`tron_tpu/cli.py`, which picks a JAX device index).

The port never substitutes the CPU for a missing card: a run that asks for
a GPU either gets one or fails here.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(index: int = 0) -> torch.device:
    """The CUDA device ``cuda:index``; raises if CUDA is missing or the
    index is out of range."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA device {index} requested but torch {torch.__version__} "
            "sees no CUDA device"
        )
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise RuntimeError(
            f"CUDA device index {index} out of range: {count} device(s) visible"
        )
    return torch.device("cuda", index)


def parse_device(arg: str) -> torch.device:
    """A tool's ``--device`` value: a CUDA device index (checked by
    ``resolve_device``), or ``cpu``, the only way to run on the host."""
    return torch.device("cpu") if arg == "cpu" else resolve_device(int(arg))


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU): a host clock read after it times the device's work too."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe(device: torch.device) -> tuple[str, str]:
    """(name, power limit) of ``device`` as ``nvidia-smi
    --query-gpu=name,power.limit`` reads them; where nvidia-smi is missing,
    the name from torch and a power limit that says it was not read.  On
    the CPU: ("cpu", "not measured")."""
    if device.type != "cuda":
        return "cpu", "not measured"
    cmd = ["nvidia-smi", "-i", str(device.index or 0),
           "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    except FileNotFoundError:
        return torch.cuda.get_device_name(device), "not read (no nvidia-smi)"
    name, limit = (x.strip() for x in out.strip().splitlines()[0].rsplit(",", 1))
    return name, limit
