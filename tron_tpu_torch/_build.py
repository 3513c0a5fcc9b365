"""Build and load the hand-written CUDA kernels (`csrc/*.cu`, with the
shared device code of `csrc/*.cuh`).

The sources are compiled with nvcc, one process per source, all started
together, and linked into one shared library with a plain C interface,
loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas=-v -c -o <obj> csrc/<name>.cu                  (each source)
    nvcc -shared -o build/tron_tpu_torch/libtron_torch_<hash>.so <objs>

The build runs on first use, when a CUDA tensor first reaches a kernel
wrapper, so importing the package never needs nvcc.  The library lands in
`build/tron_tpu_torch/` beside the package, keyed by a hash of the sources
(headers included) and flags, and a later process with the same sources
reuses it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tron_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    log: str  # nvcc's output (registers and spills from -Xptxas=-v); "" if reused


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        Path(home) / "bin" / "nvcc" if home else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand is not None and cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "tron_tpu_torch are compiled on first use"
        )
    return found


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cs = ctypes.c_size_t
    lib.tron_grid_radial2d_planes.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, cf, ci, vp, cs, vp,
    ]
    lib.tron_grid_radial2d_planes.restype = ci
    lib.tron_grid_radial2d_workspace_bytes.argtypes = [ci, ci, ci, ci, cf]
    lib.tron_grid_radial2d_workspace_bytes.restype = cs
    lib.tron_grid_radial2d_batched_planes.argtypes = lib.tron_grid_radial2d_planes.argtypes
    lib.tron_grid_radial2d_batched_planes.restype = ci
    lib.tron_grid_seg_radial2d_planes.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, cf, vp, ci, cf, ci, ci, vp, cs, vp,
    ]
    lib.tron_grid_seg_radial2d_planes.restype = ci
    lib.tron_grid_seg_radial2d_workspace_bytes.argtypes = [ci, ci, ci, ci, cf, ci]
    lib.tron_grid_seg_radial2d_workspace_bytes.restype = cs
    lib.tron_degrid_radial2d_planes.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, cf, ci, vp,
    ]
    lib.tron_degrid_radial2d_planes.restype = ci
    lib.tron_cuda_error_string.argtypes = [ci]
    lib.tron_cuda_error_string.restype = ctypes.c_char_p


@functools.cache
def load() -> Built:
    """Compile (unless a library for these exact sources exists) and load."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources + list(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libtron_torch_{h.hexdigest()[:16]}.so"
    log = ""
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [out.with_suffix(f".{os.getpid()}.{src.stem}.o") for src in sources]
        cmds = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)
        ]
        try:
            procs = [
                subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for c in cmds
            ]
            outs = [p.communicate()[0] for p in procs]
            log = "".join(outs)
            for cmd, p, o in zip(cmds, procs, outs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{o}")
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"link failed ({proc.returncode}): {' '.join(link)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
            for obj in objs:
                obj.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return Built(lib, out, log)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.tron_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
