"""Finds a cell's pieces by name, so that a later change adds a cell by
adding files and entries and edits none:

* ``BENCHMARK.json`` (beside this folder) names each cell's configuration
  and traffic mix and the metrics it reports;
* ``configs/<config>.json`` holds the configuration as it is run, and its
  ``family`` names the plain reference, ``reference/<family>.py``;
* ``traffic/<mix>.json`` holds the mix's parameters for ``traffic.py``;
* ``metrics/<metric>.py`` reads one per-layer metric from a run's record
  (its ``read(record)`` returns a number, or None where it finds nothing
  to read);
* ``checks/<cell>.json`` holds the limits that decide ``correct``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Optional

BENCH = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench: Path = BENCH) -> dict:
    """Everything one cell names: its ``BENCHMARK.json`` entry, the
    configuration, the mix, the metrics it reports (end-to-end and
    per-layer entries) and its limits (None while it has none)."""
    spec = _json(bench.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    limits = bench / "checks" / f"{name}.json"
    return {
        "workload": w,
        "config": _json(bench / "configs" / f"{w['config']}.json"),
        "mix": _json(bench / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in spec["per_layer"] if _applies(m, name)],
        "limits": _json(limits) if limits.exists() else None,
    }


def reference(family: str, bench: Path = BENCH) -> ModuleType:
    """The plain reference of ``family``: ``reference/<family>.py``."""
    return _module(bench / "reference" / f"{family}.py",
                   f"bench_reference_{family}")


def metric_reader(name: str, bench: Path = BENCH
                  ) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``metrics/<name>.py``."""
    return _module(bench / "metrics" / f"{name}.py",
                   "bench_metric_" + name.replace(".", "_").replace("-", "_")
                   ).read


def read_metrics(entries, record: dict, bench: Path = BENCH
                 ) -> Dict[str, dict]:
    """The per-layer metrics of ``entries`` that find something to read,
    each ``{"value", "unit"}``."""
    out = {}
    for m in entries:
        v = metric_reader(m["name"], bench)(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
