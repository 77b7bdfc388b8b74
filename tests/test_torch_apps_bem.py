"""Port vs reference: the two BEM applications, roomsim_bem and qa_suite_bem.

On the CPU in float64: roomsim on the reference test's tiny room
(tests/test_common_apps.py, mesh_resolution 3, 432 elements) gives the JAX
app's SPL to 1e-9 dB with the auto tier (LU) and with GMRES, and its CLI
writes the JSON; the four QA case functions at subdivision 1 give the JAX
package's rel_l2 to 1e-9 (relative); the nine non-FMM cases of
qa_bem_results/summary.json at subdivision 2 give the recorded values to
1e-6 (no JAX); ``main --fast --cpu`` exits 0. Every FMM route of roomsim
picks the FMM tier (``_solve_room_fmm``), and that tier on the tiny room
gives the JAX app's SPL to 1e-6 dB with equal GMRES iterations; the QA
``slfmm`` case at subdivision 1 gives the JAX package's rel_l2 to 1e-9
(relative); the QA ``mlfmm`` case raises a ValueError naming slice 5b
before any assembly. The FMM comparisons run the reference with its
float32 near-block quadrature and static row sums in float64
(``reference_in_float64``, as in tests/test_torch_fmm.py, whose docstring
says why). Tests marked ``cuda`` run small_room.json on the card against
the CPU in float64.
"""

import contextlib

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import mathaudio_tpu.apps.qa_suite_bem as jax_qa
import mathaudio_tpu.apps.roomsim_bem as jax_roomsim
import mathaudio_tpu.bem.fmm as jax_fmm
import mathaudio_tpu.common as jax_common
import mathaudio_tpu_torch.apps.qa_suite_bem as qa
import mathaudio_tpu_torch.apps.roomsim_bem as roomsim
import mathaudio_tpu_torch.common as common

ROOT = Path(__file__).resolve().parents[1]
CPU64 = dict(dtype=torch.float64, device="cpu")
TINY = {  # tests/test_common_apps.py TestRoomSimApps.tiny_config, at mesh_resolution 3
    "room": {"type": "rectangular", "width": 2.0, "depth": 2.0, "height": 2.0},
    "sources": [{"name": "s", "position": {"x": 0.5, "y": 0.5, "z": 1.0}}],
    "listening_positions": [{"x": 1.2, "y": 1.4, "z": 1.0}],
    "frequencies": {"min_freq": 50.0, "max_freq": 90.0, "num_points": 3},
    "boundaries": {"walls": {"type": "absorption", "coefficient": 0.2}},
    "solver": {"mesh_resolution": 3, "gmres": {"tolerance": 1e-6}},
}
# the recorded run's cases without FMM at subdivision 2: (function, ka, keywords)
RECORDED = [("sphere_case", ka, {}) for ka in (0.1, 0.5, 1.0)] + [
    ("sphere_case", 0.5, {"solver": s}) for s in ("lu", "gmres")] + [
    ("pulsating_case", ka, {}) for ka in (0.5, 1.0, 2.0, math.pi)]


class _Float64Numpy:
    """numpy with ``float32`` reading float64."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


@contextlib.contextmanager
def reference_in_float64():
    """The reference's float32 FMM near-block quadrature and static row
    sums run in float64 (see tests/test_torch_fmm.py)."""
    saved = jax_fmm.np
    jax_fmm.np = _Float64Numpy()
    try:
        yield
    finally:
        jax_fmm.np = saved


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("solver", ["auto", "gmres"])
def test_roomsim_matches_the_reference_app(solver):
    ref = jax_roomsim.run_bem_simulation(jax_common.RoomConfig.from_dict(TINY), verbose=0,
                                         solver=solver)
    got = roomsim.run_bem_simulation(common.RoomConfig.from_dict(TINY), verbose=0, solver=solver,
                                     **CPU64)
    assert got.metadata["num_elements"] == ref.metadata["num_elements"] == 432
    spl, ref_spl = (np.array([r.spl_db for r in res.results]) for res in (got, ref))
    assert spl.shape == (3, 1) and np.abs(spl - ref_spl).max() <= 1e-9
    assert [r.converged for r in got.results] == [r.converged for r in ref.results] == [True] * 3
    for r, w in zip(got.results, ref.results):
        np.testing.assert_allclose(r.pressure_real + r.pressure_imag,
                                   w.pressure_real + w.pressure_imag, rtol=1e-9)
    assert (min(r.iterations for r in got.results) > 0) == (solver == "gmres")
    assert sorted(got.to_dict()) == sorted(ref.to_dict())
    assert sorted(got.metadata) == sorted(ref.metadata)
    assert got.metadata["wall_admittance"] == ref.metadata["wall_admittance"]


def test_roomsim_cli_writes_the_json_on_the_cpu(tmp_path):
    cfg = tmp_path / "tiny.json"
    common.RoomConfig.from_dict({**TINY, "frequencies": {
        "min_freq": 60.0, "max_freq": 60.0, "num_points": 1}}).to_file(str(cfg))
    out = tmp_path / "out.json"
    assert roomsim.main([str(cfg), "--cpu", "-o", str(out), "-v", "0"]) == 0
    with open(out) as fh:
        d = json.load(fh)
    assert d["metadata"]["engine"] == "bem" and d["metadata"]["generator"] == "mathaudio_tpu_torch"
    assert len(d["results"]) == 1 and np.isfinite(d["results"][0]["spl_db"]).all()
    assert d["results"][0]["converged"] and d["config"]["room"] == TINY["room"]


def _never_assembles(monkeypatch, module, name):
    def fail(*args, **kwargs):
        raise AssertionError("the FMM route reached the assembly")

    monkeypatch.setattr(module, name, fail)


class _Routed(Exception):
    pass


@pytest.mark.parametrize("route", ["fmm", "fmm-ilu", "fmm-batched", "fmm_ilu", "auto N>=4000",
                                   "auto method fmm"])
def test_roomsim_fmm_routes_pick_the_fmm_tier(route, monkeypatch):
    """Each FMM route reaches ``_solve_room_fmm`` (stopped there) and never
    the dense ``solve_room_bem``."""
    _never_assembles(monkeypatch, roomsim, "solve_room_bem")
    reached = []

    def fmm_tier(mesh, f, sources, beta, **kw):
        reached.append(mesh.num_elements)
        raise _Routed

    monkeypatch.setattr(roomsim, "_solve_room_fmm", fmm_tier)
    cfg = common.RoomConfig.from_dict(TINY)
    solver = route
    if route == "auto N>=4000":  # 9408 elements
        cfg.solver.method, cfg.solver.mesh_resolution, solver = "gmres", 14, "auto"
    elif route == "auto method fmm":  # 1728 elements; below 1000 the table picks LU first
        cfg.solver.method, cfg.solver.mesh_resolution, solver = "fmm-ilu", 6, "auto"
    with pytest.raises(_Routed):
        roomsim.run_bem_simulation(cfg, verbose=0, solver=solver, **CPU64)
    assert reached == [{"auto N>=4000": 9408, "auto method fmm": 1728}.get(route, 432)]
    assert roomsim.solver_tier(cfg, reached[0], solver) == "fmm"
    with pytest.raises(SystemExit):
        roomsim.run_bem_simulation(cfg, verbose=0, solver="cholesky", **CPU64)


def test_roomsim_fmm_tier_matches_the_reference_app(monkeypatch):
    """The FMM tier with --cpu (float64, tau 1e8, near ILU(0), GMRES at
    restart 50, tol 1e-7) on the tiny room at 50 and 90 Hz."""
    tiny = dict(TINY, frequencies={"min_freq": 50.0, "max_freq": 90.0, "num_points": 2})
    infos, solve = [], jax_roomsim._solve_room_fmm

    def keep(*args, **kw):
        sol = solve(*args, **kw)
        infos.append(sol.info)
        return sol

    monkeypatch.setattr(jax_roomsim, "_solve_room_fmm", keep)
    with reference_in_float64():
        ref = jax_roomsim.run_bem_simulation(jax_common.RoomConfig.from_dict(tiny), verbose=0,
                                             solver="fmm")
    got = roomsim.run_bem_simulation(common.RoomConfig.from_dict(tiny), verbose=0, solver="fmm",
                                     **CPU64)
    spl, ref_spl = (np.array([r.spl_db for r in res.results]) for res in (got, ref))
    assert spl.shape == (2, 1) and np.abs(spl - ref_spl).max() <= 1e-6
    assert [r.iterations for r in got.results] == [i["iterations"] for i in infos]
    assert [r.converged for r in got.results] == [r.converged for r in ref.results] == [True] * 2


def test_solver_tier_is_the_reference_table():
    cfg = common.RoomConfig.from_dict(TINY)
    assert cfg.solver.method == "direct" and roomsim.solver_tier(cfg, 3000) == "lu"
    cfg.solver.method = "gmres"
    assert roomsim.solver_tier(cfg, 999) == "lu" and roomsim.solver_tier(cfg, 1000) == "gmres"
    assert roomsim.solver_tier(cfg, 3999) == "gmres"
    assert roomsim.solver_tier(cfg, 5000, "direct") == "lu"
    for s in ("gmres", "gmres-ilu", "gmres_jacobi"):
        assert roomsim.solver_tier(cfg, 5000, s) == "gmres"
    for s in ("fmm", "fmm-ilu", "fmm_batched"):
        assert roomsim.solver_tier(cfg, 500, s) == "fmm"
    assert roomsim.solver_tier(cfg, 4000) == "fmm"
    cfg.solver.method = "fmm"
    assert roomsim.solver_tier(cfg, 1000) == "fmm" and roomsim.solver_tier(cfg, 999) == "lu"
    cfg.solver.method = "direct"
    assert roomsim.solver_tier(cfg, 9000) == "lu"


CASES = [("sphere_case", 1.0), ("cavity_case", 1.0), ("pulsating_case", 1.0),
         ("mixed_pulsating_case", 1.0)]


@pytest.mark.parametrize("name,ka", CASES, ids=[c[0] for c in CASES])
def test_qa_case_matches_the_reference(name, ka, tmp_path):
    (tmp_path / "ref").mkdir()
    ref = getattr(jax_qa, name)(ka, 1, str(tmp_path / "ref"), verbose=0)
    got = getattr(qa, name)(ka, 1, str(tmp_path), verbose=0, **CPU64)
    assert got.name == ref.name and got.parameters == ref.parameters
    assert abs(got.metrics.l2_relative / ref.metrics.l2_relative - 1) <= 1e-9
    np.testing.assert_allclose(got.analytical.pressure_real, ref.analytical.pressure_real,
                               rtol=1e-10, atol=1e-12)
    assert got.metadata.backend == "cpu" and got.metadata.solver == ref.metadata.solver
    assert (tmp_path / {"sphere_case": "sphere_ka1.json", "cavity_case": "cavity_ka1.json",
                        "pulsating_case": "pulsating_ka1.json",
                        "mixed_pulsating_case": "mixed_pulsating_ka1.json"}[name]).exists()


@pytest.fixture(scope="module")
def recorded():
    with open(ROOT / "qa_bem_results" / "summary.json") as fh:
        return {c["name"]: c["rel_l2"] for c in json.load(fh)["cases"]}


@pytest.mark.parametrize("fn,ka,kw", RECORDED, ids=[f"{f}_{ka:g}_{kw.get('solver', 'auto')}"
                                                    for f, ka, kw in RECORDED])
def test_qa_recorded_case_without_fmm(fn, ka, kw, recorded, tmp_path):
    r = getattr(qa, fn)(ka, 2, str(tmp_path), 0, **kw, **CPU64)
    assert abs(r.metrics.l2_relative / recorded[r.name] - 1) <= 1e-6, r.name


def test_qa_main_fast_on_the_cpu(tmp_path, capsys):
    assert qa.main(["--fast", "--cpu", "-o", str(tmp_path)]) == 0
    with open(tmp_path / "summary.json") as fh:
        summary = json.load(fh)
    assert summary["total"] == summary["passed"] == 8
    assert len(list(tmp_path.glob("*.json"))) == 9
    out = capsys.readouterr().out  # a summary line per case, then the cases as JSON
    assert [c["name"] for c in json.loads(out[out.index("\n[") + 1:])] == [
        c["name"] for c in summary["cases"]]


def test_qa_slfmm_case_matches_the_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    with reference_in_float64():
        ref = jax_qa.sphere_case(0.5, 1, str(tmp_path / "ref"), 0, "slfmm")
    got = qa.sphere_case(0.5, 1, str(tmp_path), 0, "slfmm", **CPU64)
    assert got.name == ref.name == "sphere_scattering_ka0.5_slfmm"
    assert got.parameters == ref.parameters and got.metadata.solver == ref.metadata.solver
    assert abs(got.metrics.l2_relative / ref.metrics.l2_relative - 1) <= 1e-9


def test_qa_mlfmm_case_names_slice_5b_before_assembly(tmp_path, monkeypatch):
    import mathaudio_tpu_torch.bem.solver as bem_solver

    for name in ("assemble_burton_miller", "assemble_collocation_matrix", "build_slfmm_system"):
        _never_assembles(monkeypatch, bem_solver, name)
    with pytest.raises(ValueError, match="slice 5b"):
        qa.sphere_case(0.5, 1, str(tmp_path), 0, "mlfmm", **CPU64)


def test_qa_tables_are_the_references():
    assert {k: (m.value, a.value) for k, (m, a) in qa._SOLVER_MATRIX.items()} == {
        k: (m.value, a.value) for k, (m, a) in jax_qa._SOLVER_MATRIX.items()}
    for n in (320, 999, 1000, 5120):
        assert qa.select_solver(n).value == jax_qa.select_solver(n).value


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_small_room_on_the_card_matches_the_cpu(cuda_device):
    cfg = common.RoomConfig.from_file(str(ROOT / "configs" / "small_room.json"))
    card = roomsim.run_bem_simulation(cfg, verbose=0, device=cuda_device)
    cpu = roomsim.run_bem_simulation(cfg, verbose=0, **CPU64)
    spl, ref = (np.array([r.spl_db for r in res.results]) for res in (card, cpu))
    assert spl.shape == (6, 2) and np.abs(spl - ref).max() <= 0.01
    assert all(r.converged for r in card.results)


@pytest.mark.cuda
def test_qa_fast_on_the_card(cuda_device, tmp_path):
    assert qa.main(["--fast", "-o", str(tmp_path)]) == 0
    with open(tmp_path / "summary.json") as fh:
        assert json.load(fh)["passed"] == 8
