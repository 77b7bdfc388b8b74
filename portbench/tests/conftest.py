"""A tiny copy of the benchmark for CPU tests: the real files under a
temporary root, plus a FEM and a BEM cell small enough for the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY_FEM, TINY_BEM = "fem_tiny_cell", "bem_tiny_cell"


def make_root(tmp: Path) -> Path:
    """Copy BENCHMARK.json and portbench's data files to ``tmp`` and add
    the two tiny cells to every metric that lists a cell of their kind."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "portbench/configs/fem_room_nm.json").read_text())
    cfg["sweep_knobs"].update(freq_chunk=16, warm_stride=4, mg_coarse_anchors=4)
    (tmp / "portbench/configs/fem_tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "fem_tiny", "source": "tiny", "reduced": [],
                             "file": "portbench/configs/fem_tiny.json", "why": "tests"})
    room = json.loads((REPO / "portbench/workloads/room_n32_band4096.json").read_text())
    room.update(mesh_cells=8, lanes=32, trace_sweeps=2)
    (tmp / "portbench/workloads/room_tiny.json").write_text(json.dumps(room))
    sphere = json.loads((REPO / "portbench/workloads/sphere_bm_s5_band8.json").read_text())
    sphere.update(subdivisions=2, lanes=4, trace_sweeps=2)
    (tmp / "portbench/workloads/sphere_tiny.json").write_text(json.dumps(sphere))
    bench["workloads"] += [
        {"name": TINY_FEM, "config": "fem_tiny", "traffic": "room_tiny", "chips": 1, "why": "t"},
        {"name": TINY_BEM, "config": "bem_sphere_dense", "traffic": "sphere_tiny", "chips": 1,
         "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads")
        if cells is not None:
            cells += [TINY_FEM] if any(c.startswith("fem") for c in cells) else []
            cells += [TINY_BEM] if any(c.startswith("bem") for c in cells) else []
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cpu():
    return torch.device("cpu")
