"""Finds a cell's parts by name: its entry in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its correctness limits (`limits/<cell>.json`),
the plain reference its mix names (`reference/<name>.py`, "recon" unless
the mix says otherwise) and the reader of each per-layer metric it reports
(`metrics/<name>.py`, a module with ``read(trace) -> float | None``).  A
later change adds a configuration, a mix, a reference or a metric as new
files and entries and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, as it is
    traffic: dict         # the traffic mix's file, as it is
    limits: dict          # name -> {"limit": ..., ...}
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path            # the folder the parts were found in

    @property
    def recon(self) -> dict:
        """The recon's settings: the configuration's, then the mix's changes."""
        return {**self.config["recon"], **self.traffic["recon"]}

    @property
    def reference(self) -> str:
        """The name of the plain reference the mix is compared with."""
        return self.traffic.get("reference", "recon")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = HERE, spec_file: Path | None = None) -> Cell:
    """The cell ``name`` of ``spec_file`` (the checkout's `BENCHMARK.json`
    by default), its parts read from under ``root``."""
    spec = _load_json(spec_file or root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in the benchmark; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_load_json(root.parent / configs[w["config"]]["file"]),
        traffic=_load_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(root / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        root=root,
    )


def _load_module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = HERE):
    """The ``read`` function of `metrics/<name>.py` under ``root``."""
    return _load_module(root / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read


def reference(cell: Cell):
    """The plain reference the cell's mix names, `reference/<name>.py` under
    the cell's root: a module with ``SETTINGS`` (the recon settings it works
    out, each with the values it takes, None for any) and ``Series(indata,
    recon, device)``, whose ``frames(zs, quant=..., block=...)`` returns one
    tensor per frame of ``zs``, stacked on the first axis."""
    name = cell.reference
    return _load_module(cell.root / "reference" / f"{name}.py", f"benchmark_reference_{name}")
