"""The benchmark's data, found by name.

BENCHMARK.json (at the checkout's root) lists the cells; a cell names a
configuration, whose file BENCHMARK.json gives, and a traffic mix, read
from traffic/<mix>.json. Each per-layer metric's reader is
metrics/<metric>.py, and each cell's correctness limits are
limits/<cell>.json. Adding a cell, a mix, a configuration or a metric adds
files and entries only; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = "benchmark"
PORT = "targetvae_tpu_torch"      # the program under test, beside HERE


@dataclass
class Cell:
    name: str
    chips: int
    config: dict             # the configuration's file
    traffic: dict            # the traffic mix's file
    end_to_end: list         # BENCHMARK.json's entries this cell reports
    per_layer: list
    limits: dict             # number -> {"limit": ..., ...}
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files; raises
    KeyError for a cell the file does not list."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(root / HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                limits=_read_json(root / HERE / "limits" / f"{name}.json"),
                root=root)


def metric_reader(name: str, root: Path = ROOT):
    """The module metrics/<name>.py, whose read(trace) returns the metric's
    value or None where the trace holds nothing it reads."""
    path = root / HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
