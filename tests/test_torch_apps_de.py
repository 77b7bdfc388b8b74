"""Port vs reference: the four DE applications of slice 7b on the CPU.

run_de and benchmark_convergence list what the reference lists, byte for
byte (the 187 generated configurations field for field); run_de and
benchmark_convergence solve on the CPU with ``--device cpu`` and report
with the reference's keys; plot_functions' z grids and metadata JSON and
plot_de's HTML are the reference's. No DE runs on the JAX side (its
generation step compiles per configuration): the solves are held to the
reference's own test limits (tests/test_common_apps.py TestDeApps).
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from mathaudio_tpu.apps import benchmark_convergence as ref_bc
from mathaudio_tpu.apps import plot_de as ref_plot_de
from mathaudio_tpu.apps import plot_functions as ref_plot_functions
from mathaudio_tpu.apps import run_de as ref_run_de
from mathaudio_tpu.testfunctions import FUNCTIONS as REF_FUNCTIONS
from mathaudio_tpu_torch.apps import benchmark_convergence, plot_de, plot_functions, run_de

# mathaudio_tpu/apps/run_de.py main's report, in its order
RUN_DE_KEYS = ["function", "x", "fun", "expected_minimum", "success", "message", "nit", "nfev"]
SHOWCASE = ["rastrigin", "ackley", "rosenbrock", "himmelblau", "eggholder", "levy"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stdout(capsys, main, argv):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("app", ["run_de", "benchmark_convergence"])
def test_list_is_the_reference(capsys, app):
    port, ref = {"run_de": (run_de, ref_run_de),
                 "benchmark_convergence": (benchmark_convergence, ref_bc)}[app]
    got = _stdout(capsys, port.main, ["--list"])
    want = _stdout(capsys, ref.main, ["--list"])
    assert got == want and got[0] == 0
    if app == "benchmark_convergence":
        assert want[1].splitlines()[-1] == "187 benchmarks"
    else:
        assert len(want[1].splitlines()) == 105


def _config_fields(cfg):
    d = dataclasses.asdict(cfg)
    d["strategy"] = cfg.strategy.value
    return d


@pytest.mark.parametrize("quick", [False, True])
def test_generated_benchmarks_are_the_reference(quick):
    got = benchmark_convergence.generate_all_benchmarks(seed=7, quick=quick)
    want = ref_bc.generate_all_benchmarks(seed=7, quick=quick)
    assert len(got) == len(want) == 187
    # repr: the NaN minima compare equal
    assert repr([_config_fields(c) for c in got]) == repr([_config_fields(c) for c in want])
    assert sum(c.name.endswith("_10d") for c in got) == 46


def test_run_de_solves_sphere_on_the_cpu(capsys):
    """tests/test_common_apps.py TestDeApps.test_run_de_cli's run and limit."""
    rc, out = _stdout(capsys, run_de.main, ["sphere", "--maxiter", "80", "--seed", "42",
                                            "--tol", "0", "--device", "cpu"])
    report = json.loads(out)
    assert rc == 0 and list(report) == RUN_DE_KEYS
    assert report["fun"] < 1e-4 and report["nit"] == 80 and report["expected_minimum"] == 0.0
    assert report["nfev"] == 30 * 81 and len(report["x"]) == 2


def test_run_de_constrained_and_recorded(capsys, tmp_path):
    """keanes_bump_objective's inequality constraints become penalties,
    --record writes the recorder's CSV, --jit-loop and --polish run."""
    trace = tmp_path / "keane.csv"
    rc, out = _stdout(capsys, run_de.main, ["keanes_bump_objective", "--maxiter", "60", "--seed",
                                            "3", "--record", str(trace), "--device", "cpu"])
    report = json.loads(out)
    x = np.array(report["x"])
    assert rc == 0 and list(report) == RUN_DE_KEYS
    assert np.prod(x) >= 0.75 - 1e-3 and report["fun"] < -0.2
    rows = trace.read_text().splitlines()
    assert rows[0] == "eval_id,generation,x0,x1,f,best_so_far,improvement"
    assert len(rows) == 1 + report["nit"]
    rc, out = _stdout(capsys, run_de.main, ["booth", "--maxiter", "200", "--seed", "1",
                                            "--jit-loop", "--polish", "--device", "cpu"])
    report = json.loads(out)
    assert rc == 0 and report["fun"] < 1e-8 and abs(report["x"][0] - 1.0) < 1e-4


def test_benchmark_convergence_booth_on_the_cpu(capsys, tmp_path):
    """tests/test_common_apps.py TestDeApps.test_benchmark_convergence_cli's
    run and checks, with the summary rows holding the reference's keys."""
    rc, out = _stdout(capsys, benchmark_convergence.main,
                      ["-o", str(tmp_path), "-f", "booth", "--strategies", "best1bin",
                       "--quick", "--device", "cpu"])
    assert rc == 0 and "TOTAL: 1/1 pass" in out
    rows = json.loads((tmp_path / "summary.json").read_text())
    assert len(rows) == 1 and rows[0]["success"] and rows[0]["fun_error"] < rows[0]["fun_tolerance"]
    assert list(rows[0]) == [f.name for f in dataclasses.fields(ref_bc.BenchmarkResult)]
    assert rows[0]["error_message"] is None and rows[0]["strategy"] == "best1bin"
    csvs = list(tmp_path.glob("booth_*best1bin.csv"))
    assert len(csvs) == 1 and csvs[0].stat().st_size > 0


def _plot_data(html):
    m = re.search(r'Plotly\.newPlot\("plot", (.*), (\{.*\})\);</script>', html)
    return json.loads(m.group(1)), json.loads(m.group(2))


def test_plot_functions_is_the_reference(tmp_path):
    """The showcase set at resolution 8: the same grids, z within 1e-12 of
    max(1, |z|) of the reference's (jitted) evaluation, the same markers and
    layout; then the metadata JSON of every function, byte for byte."""
    out, ref_out = tmp_path / "port", tmp_path / "ref"
    for main, where, extra in ((plot_functions.main, out, ["--device", "cpu"]),
                               (ref_plot_functions.main, ref_out, [])):
        assert main(["--resolution", "8", "--metadata", "-o", str(where)] + extra) == 0
    for name in SHOWCASE:
        (data, layout), (ref_data, ref_layout) = (
            _plot_data((where / f"{name}.html").read_text()) for where in (out, ref_out))
        assert layout == ref_layout and len(data) == len(ref_data)
        z, ref_z = np.array(data[0].pop("z")), np.array(ref_data[0].pop("z"))
        assert z.shape == (8, 8)
        assert np.all(np.abs(z - ref_z) <= 1e-12 * np.maximum(1.0, np.abs(ref_z))), name
        assert data == ref_data
        assert (out / f"{name}.json").read_text() == (ref_out / f"{name}.json").read_text()
    for main, where, extra in ((plot_functions.main, out, []), (ref_plot_functions.main, ref_out, [])):
        assert main(["all", "--metadata", "--no-html", "-o", str(where)] + extra) == 0
    names = sorted(p.name for p in ref_out.glob("*.json"))
    assert len(names) == 105 and sorted(p.name for p in out.glob("*.json")) == names
    for name in names:
        assert (out / name).read_text() == (ref_out / name).read_text(), name


def test_plot_functions_all_skips_what_2d_cannot_evaluate(tmp_path):
    """``all`` plots every function defined in 2-D (any width, or 2 among its
    widths) and skips the rest as it skips 1-D ones; the reference's ``all``
    stops with a TypeError at hartman_3d."""
    assert plot_functions.main(["all", "--resolution", "4", "-o", str(tmp_path), "--device",
                                "cpu"]) == 0
    plotted = sorted(p.stem for p in tmp_path.glob("*.html"))
    want = sorted(n for n, (_, m) in REF_FUNCTIONS.items()
                  if len(m.bounds) >= 2 and (not m.dimensions or 2 in m.dimensions))
    assert plotted == want and len(plotted) == 95
    assert not {"colville", "power_sum", "powell", "shekel", "hartman_3d"} & set(plotted)


def test_plot_de_is_the_reference(capsys, tmp_path):
    """Recorder traces (from a port run) and the reference's other CSV form
    (iter,best) give the reference's HTML, string for string."""
    assert benchmark_convergence.main(["-o", str(tmp_path), "-f", "matyas_2d", "--strategies",
                                       "best1bin", "rand1bin", "--quick", "--device", "cpu"]) == 0
    (tmp_path / "plain.csv").write_text("iter,best\n0,3.5\n1,0.25\n2,0.0\n")
    capsys.readouterr()
    pattern = str(tmp_path / "*.csv")
    htmls = []
    for main, name in ((plot_de.main, "port.html"), (ref_plot_de.main, "ref.html")):
        assert main([pattern, "-o", str(tmp_path / name), "--title", "matyas"]) == 0
        htmls.append((tmp_path / name).read_text())
    assert htmls[0] == htmls[1]
    data, _ = _plot_data(htmls[0])
    assert [d["name"] for d in data] == ["matyas_2d_best1bin", "matyas_2d_rand1bin", "plain"]
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "header_only.csv").write_text("iter,best\n")
    assert plot_de.main([str(empty / "*.csv"), "-o", str(empty / "x.html")]) == 1
