"""What BENCHMARK.json names, found by name in files of their own.

  configs/<config>.json   one configuration: the solid, the network's
                          widths, the k-list, the starting checkpoint
  traffic/<traffic>.json  one traffic mix: precision, batch, chunks, the
                          optimizer ('kfac' or 'none') and its settings,
                          MCMC steps, warm-up, the reference's chunk and
                          the iterations profiled
  limits/<cell>.json      the limit of each number that decides `correct`
  metrics/<metric>.py     one reader per metric: read(run) -> number or None
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def cells(conf: dict) -> int:
    """Primitive cells in the simulation cell."""
    return round(abs(float(np.linalg.det(np.asarray(conf["supercell"], float)))))


def nelectron(conf: dict) -> int:
    return round(sum(a["charge"] for a in conf["atoms"])) * cells(conf)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


class Cell:
    """One entry of BENCHMARK.json's workloads with everything it names."""

    def __init__(self, name: str, bench: dict = None, here: Path = HERE):
        bench = bench if bench is not None else benchmark()
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(entries)})")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(here / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(here / "traffic" / f"{self.entry['traffic']}.json")
        limits = here / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]
        self.here = here

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace: bool):
        return self.per_layer if trace else self.end_to_end


def reader(name: str):
    """The metric's reader: metrics/<name>.py's read(run)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
