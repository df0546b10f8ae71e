"""Everything of a cell found by name: the manifest (``BENCHMARK.json`` at
the checkout's root), a configuration's file, a traffic mix's file
(``benchmark/traffic/<name>.json``), a per-layer metric's reader
(``benchmark/metrics/<name>.py``, a function ``read(ctx)``) and a cell's
correctness limits (``benchmark/limits/<cell>.json``).  A new cell, mix or
metric is a new file and a new entry; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def limits(cell: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "limits" / f"{cell}.json").read_text())


def reader(name: str, bench: Path = BENCH):
    """The ``read`` function of metric ``name``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(manifest: dict, group: str, cell: str) -> list:
    """The entries of ``group`` ("end_to_end" or "per_layer") that cell
    ``cell`` reports: those that list it, and those that list no cells."""
    return [m for m in manifest[group]
            if cell in m.get("workloads", [cell])]
