"""Find a cell's pieces by name: everything the harness runs is data.

Under the benchmark's root (the checkout's root, which holds
``BENCHMARK.json``):

* ``BENCHMARK.json``: the cells (``workloads``) and the metrics;
* ``perfbench/configs/<config>.json``: a configuration's sizes, with the
  name of its plain reference under ``perfbench/reference/``;
* ``perfbench/traffic/<traffic>.json``: a traffic mix's parameters, naming
  the general driver (``perfbench/traffic/<driver>.py``) that runs it;
* ``perfbench/workloads/<cell>.json``: a cell's correctness limits;
* ``perfbench/metrics/<metric>.py``: a reader of one metric, ``read(rec)``.

A later cell, configuration, traffic mix or metric is a new file and a new
entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PKG = "perfbench"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]      # the cell's end-to-end metrics
    per_layer: List[dict]       # the cell's per-layer metrics


class Bench:
    """The benchmark rooted at ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = _json(self.root / "BENCHMARK.json")
        self.dir = self.root / PKG

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str) -> Cell:
        w = self._entry("workloads", name)
        self._entry("configs", w["config"])
        config = _json(self.dir / "configs" / f"{w['config']}.json")
        traffic = _json(self.dir / "traffic" / f"{w['traffic']}.json")
        limits = _json(self.dir / "workloads" / f"{name}.json")["limits"]
        return Cell(name, config, traffic, limits,
                    [m for m in self.spec["end_to_end"]
                     if self._applies(m, name)],
                    [m for m in self.spec["per_layer"]
                     if self._applies(m, name)])

    def driver(self, traffic: dict) -> ModuleType:
        kind = traffic["driver"]
        return load_module(self.dir / "traffic" / f"{kind}.py",
                           f"{PKG}_traffic_{kind}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"{PKG}_metric_{metric.replace('.', '_')}")

    def read_metrics(self, metrics: List[dict], rec: dict
                     ) -> Dict[str, dict]:
        """Each metric's reader over the run's record; a reader that finds
        nothing to read returns None and the metric is left out."""
        out: Dict[str, dict] = {}
        for m in metrics:
            value: Optional[float] = self.reader(m["name"]).read(rec)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
