"""Discovery: everything of one cell is found by the names in
``BENCHMARK.json``. A configuration is the JSON file its entry names; a
cell's traffic mix is ``workloads/<traffic>.json``; a metric is read by
``metrics/<metric name>.py``; the module that drives the program for a
configuration is ``systems/<system>.py``, named in its file. Adding a cell, a configuration
or a metric is adding files and entries: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout that holds BENCHMARK.json


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and metrics."""

    def __init__(self, bench: dict, name: str, root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = _load_json(_bench_dir(root) / "workloads"
                                  / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def metrics(self, trace: bool):
        return self.per_layer if trace else self.end_to_end


def _bench_dir(root: Path) -> Path:
    return root / HERE.name


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path, name: str) -> Cell:
    """The cell ``name`` of the BENCHMARK.json at ``root``."""
    return Cell(_load_json(root / "BENCHMARK.json"), name, root)


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}_{path.stem}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {tag} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """The ``read(record)`` of ``metrics/<metric>.py``."""
    return _module(_bench_dir(root) / "metrics" / f"{metric}.py", "metric").read


def system(root: Path, name: str):
    """The module ``systems/<name>.py``."""
    return _module(_bench_dir(root) / "systems" / f"{name}.py", "system")
