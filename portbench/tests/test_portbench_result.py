"""The result line, the run's exit without a card, and the modules a run loads."""

from __future__ import annotations

import subprocess
import sys

import pytest

from portbench.harness import forbidden_modules, run
from portbench.tests.conftest import REPO, TINY_BEM, TINY_FEM

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", [TINY_FEM, TINY_BEM])
def test_result_keys(tiny_root, cpu, cell):
    lines = []
    result = run(tiny_root, cell, 2**31 + 11, 0.3, False, cpu, log=lines.append)
    assert list(result) == KEYS  # checks come last
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in result["metrics"].items():
        assert m["value"] > 0 and m["unit"], name
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    assert lines[-len(result["checks"]):] == [
        f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in result["checks"].items()]


def test_same_seed_same_answers(tiny_root, cpu):
    from portbench import spec
    from portbench.traffic import Traffic

    cell = spec.load(tiny_root, TINY_FEM)
    a, b = Traffic(cell.traffic, 2**33 + 1), Traffic(cell.traffic, 2**33 + 1)
    assert (a.sweep(7)["ks"] == b.sweep(7)["ks"]).all()
    assert a.check_sample(9) == b.check_sample(9) and a.check_sample(9)[0][0] == 8
    c = Traffic(cell.traffic, 2**33 + 2)
    ka, kc = a.sweep(3)["ks"], c.sweep(3)["ks"]
    assert len(ka) == len(kc) and (ka != kc).all()
    # every seed the same grid spacing inside the band, in another offset
    for ks in (ka, kc):
        assert 0.55 <= ks[0] and ks[-1] < 2.2
        assert abs((ks[1:] - ks[:-1]) - (2.2 - 0.55) / len(ks)).max() < 1e-12


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "fem_nm_n32",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_only_benchmark_files_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    (no program) a run fails and prints no result."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "fem_nm_n32",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mathaudio_tpu_torchlike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mathaudio_tpu.fem", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert forbidden_modules() == ["jax", "mathaudio_tpu.fem"]


def test_a_run_loads_no_jax(tiny_root):
    """A whole run in a fresh interpreter loads no module of JAX or of the
    JAX package."""
    code = ("import sys, torch\n"
            "from pathlib import Path\n"
            "from portbench.harness import run, forbidden_modules\n"
            f"r = run(Path({str(tiny_root)!r}), {TINY_BEM!r}, 3, 0.2, False, torch.device('cpu'),"
            " log=lambda m: None)\n"
            "print(r['correct'], forbidden_modules(), 'mathaudio_tpu_torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["True", "[]", "True"]


def _imported_roots(path):
    import ast

    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_references_no_program():
    files = sorted((REPO / "portbench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "flax", "mathaudio_tpu"}, path
        if path.parent.name == "reference":
            assert roots <= {"__future__", "math", "numpy", "torch"}, (path, roots)
