"""Finds what belongs to a cell by name: its entry in BENCHMARK.json, its
configuration (fadbench/configs/<config>.json, whose ``reference`` names
the plain model under fadbench/reference/ and its FLOP counter under
fadbench/counts/), its traffic (fadbench/traffic/<traffic>.json), its
correctness limits (fadbench/limits/<cell>.json) and a reader for each of
its metrics (fadbench/metrics/<metric>.py, a module with ``read(run)`` that
returns a number, or None where the run has nothing to read). A cell, a
configuration or a metric is added by adding files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path

    def reference(self) -> ModuleType:
        return importlib.import_module(f"fadbench.reference.{self.config['reference']}")

    def counter(self) -> ModuleType:
        return importlib.import_module(f"fadbench.counts.{self.config['reference']}")

    def reader(self, metric: str) -> ModuleType:
        path = self.bench_dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(f"fadbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = _json(Path(root) / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    bench_dir = Path(bench_dir)
    return Cell(
        name=name,
        entry=entry,
        config=_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir,
    )
