"""Where a cell's parts live: everything is found by the names that
``BENCHMARK.json`` gives, so a new cell, configuration, traffic mix or
metric is a new file and a new entry, never an edit.

* ``configs/<config>.json``: the configuration as it is run.
* ``traffic/<traffic>.json``: the traffic mix, read by ``core.drivers``.
* ``metrics/<metric name>.py``: one reader a metric, ``read(run)``.
* ``judges/<judge>.py``: what decides ``correct``, named by the traffic
  file's ``judge`` (``core/checks.py``).
* ``limits/<workload name>.json``: the limits of the cell's comparisons.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]] = None  # None: every cell

    def applies(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _metrics(entries) -> List[Metric]:
    return [Metric(name=e["name"], unit=e["unit"], workloads=e.get("workloads"))
            for e in entries]


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``workload`` of ``bench_file`` with its files read."""
    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_file = BENCH_DIR / "limits" / f"{workload}.json"
    limits = load_json(limits_file) if limits_file.exists() else {}
    e2e = [m for m in _metrics(bench["end_to_end"]) if m.applies(workload)]
    layer = [m for m in _metrics(bench["per_layer"]) if m.applies(workload)]
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer)


def _module(folder: str, name: str, what: str):
    """``<folder>/<name>.py``, loaded by its path (a name may hold dots)."""
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{what} {name!r} has no file at {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    return _module("metrics", name, "metric").read


def judge_module(name: str):
    """The judge ``judges/<name>.py``: ``outputs``, ``reference``, ``judge``,
    ``control``, ``fault`` and ``FAULTS``."""
    return _module("judges", name, "judge")
