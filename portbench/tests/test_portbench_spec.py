"""Discovery of configurations, cells and metrics by file name."""

from __future__ import annotations

import json

from portbench import spec
from portbench.harness import run
from portbench.tests.conftest import REPO, TINY_FEM, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (REPO / "portbench/systems" / f"{cfg['system']}.py").exists()
    for w in BENCH["workloads"]:
        cell = spec.load(REPO, w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert set(cell.traffic["limits"]) and cell.traffic["check"]["sweeps"] >= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(REPO, m["name"]))


def test_metric_lists_follow_the_cells():
    cell = spec.load(REPO, "bem_cbie_n20480")
    names = [m["name"] for m in cell.end_to_end]
    assert "dof_solves_per_s" not in names and "solves_per_s" in names
    assert "sweep_ms_p90" in names and "setup_s" in names
    layers = [m["name"] for m in cell.per_layer]
    assert "bem_pairwise_roofline_pct" in layers and "dia_roofline_pct" not in layers


def test_files_added_at_test_time_are_picked_up(tmp_path, cpu):
    """A new cell, traffic mix and metric are files and entries only."""
    root = make_root(tmp_path)
    (root / "portbench/metrics/lanes_per_sweep.py").write_text(
        "def read(rec):\n    return rec['sweeps'][0]['lanes']\n")
    traffic = json.loads((root / "portbench/workloads/room_tiny.json").read_text())
    traffic["lanes"] = 16
    (root / "portbench/workloads/room_tiny16.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fem_tiny16", "config": "fem_tiny",
                               "traffic": "room_tiny16", "chips": 1, "why": "added"})
    bench["end_to_end"].append({"name": "lanes_per_sweep", "unit": "lanes", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["fem_tiny16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run(root, "fem_tiny16", 5, 0.3, False, cpu, log=lambda m: None)
    assert result["metrics"]["lanes_per_sweep"]["value"] == 16
    assert result["correct"]
    assert "lanes_per_sweep" not in run(root, TINY_FEM, 5, 0.3, False, cpu,
                                        log=lambda m: None)["metrics"]
