"""Port vs reference, the slice as a whole: BemSolver (rigid, radiating
and mixed boundary conditions; LU, GMRES, BiCGStab, CGS and QMR-CGSTAB)
with the field evaluation of its solutions, and the interior room BEM
(solve_room_bem + RoomBemSolution.evaluate_pressure).

Both packages solve the same problems on an 80-element icosphere on the
CPU in float64. Surface pressures, surface dp/dn and the fields at 40
points agree to 1e-9 of the largest magnitude; every Krylov solver takes
the same number of iterations. The port also evaluates the field from the
reference's surface solution carried across as numpy arrays
(mathaudio_tpu_torch.convert), directly and through the FMM evaluation.
A ``device_mesh`` on a one-rank process group gives the unsharded answer
(tests/test_torch_spmd.py holds the sharded route at 2 and 4 ranks).
"""

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import one_rank_group
from mathaudio_tpu.bem import room_acoustics as jax_room
from mathaudio_tpu.bem import solver as jax_solver
from mathaudio_tpu.bem import types as jax_types
from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.common.source import Source as JaxSource
from mathaudio_tpu.common.types import Point3D as JaxPoint3D
from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
from mathaudio_tpu_torch.bem import room_acoustics as room
from mathaudio_tpu_torch.bem import solver, types
from mathaudio_tpu_torch.bem.postprocess import generate_sphere_eval_points
from mathaudio_tpu_torch.common.source import CrossoverFilter, Source
from mathaudio_tpu_torch.common.types import Point3D
from mathaudio_tpu_torch.convert import (
    bem_solution_from_numpy,
    boundary_condition_from_numpy,
    room_bem_solution_from_numpy,
    surface_mesh_from_numpy,
)
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

KA = 1.2
POINTS = generate_sphere_eval_points(2.0, 5, 8)  # 40 exterior points
CPU64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=1e-9):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < tol, err


def _problems(kind):
    """(reference problem, port problem) of a kind, from the same arrays."""
    jm = jax_icosphere(1.0, 1)
    tm = surface_mesh_from_numpy(jm.nodes, jm.elements)
    if kind == "rigid":
        return (jax_solver.BemProblem.rigid_sphere(KA, subdivisions=1),
                solver.BemProblem.rigid_sphere(KA, subdivisions=1))
    if kind == "radiating":
        return (jax_solver.BemProblem.radiating_sphere(KA, subdivisions=1, velocity=0.5 + 0.2j),
                solver.BemProblem.radiating_sphere(KA, subdivisions=1, velocity=0.5 + 0.2j))
    rng = np.random.default_rng(21)
    n = jm.num_elements
    values = rng.normal(size=n) + 1j * rng.normal(size=n)
    bc_types = np.where(jm.centers[:, 2] >= 0.0, 0, 1).astype(np.int32)
    adm = (0.3 + 0.1j) * np.ones(n) if kind == "mixed_admittance" else None
    return (
        jax_solver.BemProblem(jm, jax_types.PhysicsParams.from_wave_number(KA), None,
                              jax_types.BoundaryCondition(bc_types, values, adm)),
        solver.BemProblem(tm, types.PhysicsParams.from_wave_number(KA), None,
                          boundary_condition_from_numpy(bc_types, values, adm)),
    )


SOLVES = {
    # name: (problem kind, solver method, Burton–Miller)
    "rigid_bm_lu": ("rigid", "lu", True),
    "rigid_bm_gmres": ("rigid", "gmres", True),
    "rigid_cbie_gmres": ("rigid", "gmres", False),
    "radiating_bm_lu": ("radiating", "lu", True),
    "radiating_cbie_gmres": ("radiating", "gmres", False),
    "mixed_bm_gmres": ("mixed", "gmres", True),
    "mixed_cbie_lu": ("mixed", "lu", False),
    "mixed_admittance_bm_lu": ("mixed_admittance", "lu", True),
    "rigid_bm_bicgstab": ("rigid", "bicgstab", True),
    "rigid_bm_cgs": ("rigid", "cgs", True),
    "rigid_bm_qmrcgstab": ("rigid", "qmrcgstab", True),
    "rigid_cbie_bicgstab": ("rigid", "bicgstab", False),
    "mixed_bm_cgs": ("mixed", "cgs", True),
    "mixed_cbie_qmrcgstab": ("mixed", "qmrcgstab", False),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_bem_solver_matches_reference(name):
    kind, method, bm = SOLVES[name]
    jp, tp = _problems(kind)
    kw = dict(burton_miller=bm, tolerance=1e-10, restart=30)
    ref = jax_solver.BemSolver(jax_types.BemSolverConfig(
        method=jax_types.SolverMethod(method), **kw)).solve(jp)
    sol = solver.BemSolver(types.BemSolverConfig(method=types.SolverMethod(method), **kw),
                           **CPU64).solve(tp)
    assert sol.surface_pressure.dtype == torch.complex128
    _close(sol.surface_pressure, ref.surface_pressure)
    assert (sol.surface_q is None) == (ref.surface_q is None) == (kind == "rigid")
    if sol.surface_q is not None:
        _close(sol.surface_q, ref.surface_q)
    assert {k: v for k, v in sol.info.items()} == {k: v for k, v in ref.info.items()}
    if method != "lu":
        assert sol.info["converged"] and sol.info["iterations"] >= 1

    ref_field = ref.evaluate_pressure_field(POINTS)
    field = sol.evaluate_pressure_field(POINTS)
    _close(field.p_total, ref_field.p_total)
    _close(sol.evaluate_pressure(POINTS), ref_field.p_total)
    # the reference's surface solution, carried across as numpy arrays
    carried = bem_solution_from_numpy(
        tp, np.asarray(ref.surface_pressure),
        None if ref.surface_q is None else np.asarray(ref.surface_q), ref.info, **CPU64)
    _close(carried.evaluate_pressure(POINTS), ref_field.p_total, tol=1e-10)


def test_gmres_ilu_method_runs_jacobi_gmres_like_the_reference():
    _, tp = _problems("rigid")
    a = solver.BemSolver(types.BemSolverConfig(method=types.SolverMethod.GMRES_ILU), **CPU64)
    b = solver.BemSolver(types.BemSolverConfig(method=types.SolverMethod.GMRES), **CPU64)
    sa, sb = a.solve(tp), b.solve(tp)
    assert torch.equal(sa.surface_pressure, sb.surface_pressure)
    assert sa.info["iterations"] == sb.info["iterations"]


@pytest.mark.parametrize("kind", ["rigid", "mixed"])
def test_device_mesh_on_one_rank_gets_the_unsharded_answer(kind):
    """``device_mesh`` on a one-rank gloo mesh: the rigid GMRES solve runs
    row-sharded (over one rank) and the mixed one unsharded, as in the
    reference; both give the unsharded answer, and LU ignores the mesh."""
    _, tp = _problems(kind)
    gmres_cfg = dict(method=types.SolverMethod.GMRES, tolerance=1e-10)
    want = solver.BemSolver(types.BemSolverConfig(**gmres_cfg), **CPU64).solve(tp)
    with one_rank_group() as mesh:
        got = solver.BemSolver(types.BemSolverConfig(**gmres_cfg, device_mesh=mesh),
                               **CPU64).solve(tp)
        lu = solver.BemSolver(types.BemSolverConfig(device_mesh=mesh), **CPU64).solve(tp)
    assert got.info.get("sharded_over") == (1 if kind == "rigid" else None)
    assert got.info["converged"] and got.info["iterations"] == want.info["iterations"]
    _close(got.surface_pressure, want.surface_pressure, tol=1e-12)
    assert "sharded_over" not in lu.info
    _close(lu.surface_pressure, want.surface_pressure, tol=1e-8)


def test_fmm_field_evaluation_matches_reference():
    jp, tp = _problems("rigid")
    p = np.random.default_rng(9).normal(size=tp.mesh.num_elements) + 0.5j
    ref = jax_solver.BemSolution(jp, p, {}).evaluate_pressure(POINTS, method="fmm")
    sol = bem_solution_from_numpy(tp, p, **CPU64)
    _close(sol.evaluate_pressure(POINTS, method="fmm"), ref, tol=1e-10)
    with pytest.raises(ValueError, match="unknown"):
        sol.evaluate_pressure(POINTS, method="panel")


def _sources():
    spec = [((0.1, -0.2, 0.05), 1.0, None), ((-0.3, 0.1, 0.2), 0.6, 180.0)]
    ref, port = [], []
    for pos, amp, lowpass in spec:
        js, ts = (JaxSource.omnidirectional(JaxPoint3D(*pos), amp),
                  Source.omnidirectional(Point3D(*pos), amp))
        if lowpass:
            from mathaudio_tpu.common.source import CrossoverFilter as JaxCrossoverFilter

            js = js.with_crossover(JaxCrossoverFilter.lowpass(lowpass))
            ts = ts.with_crossover(CrossoverFilter.lowpass(lowpass))
        ref.append(js)
        port.append(ts)
    return ref, port


ROOMS = {
    # name: (method, wall admittance)
    "rigid_lu": ("lu", 0.0),
    "absorbing_lu": ("lu", "per_element"),
    "absorbing_gmres": ("gmres", 0.15),
    # any method but "lu" runs Jacobi-GMRES, in the reference as in the port
    "absorbing_cg": ("cg", 0.15),
}


@pytest.mark.parametrize("name", list(ROOMS))
def test_room_bem_matches_reference(name):
    method, adm = ROOMS[name]
    jm = jax_icosphere(1.0, 1)
    tm = surface_mesh_from_numpy(jm.nodes, jm.elements)
    if adm == "per_element":
        adm = np.random.default_rng(2).uniform(0.05, 0.4, jm.num_elements)
    f = KA * 343.0 / (2 * np.pi)
    jsrc, tsrc = _sources()
    cfg = dict(max_iterations=200, tolerance=1e-10, restart=30)
    ref = jax_room.solve_room_bem(jm, f, jsrc, admittance=adm, method=method,
                                  gmres_config=JaxKrylovConfig(**cfg))
    sol = room.solve_room_bem(tm, f, tsrc, admittance=adm, method=method,
                              gmres_config=KrylovConfig(**cfg), **CPU64)
    assert abs(sol.k - ref.k) < 1e-15 and sol.info == ref.info
    _close(sol.surface_pressure, ref.surface_pressure)
    inside = 0.3 * POINTS  # radius 0.6
    ref_p = ref.evaluate_pressure(inside)
    _close(sol.evaluate_pressure(inside), ref_p)
    carried = room_bem_solution_from_numpy(tm, ref.k, ref.frequency,
                                           np.asarray(ref.surface_pressure),
                                           np.asarray(ref.admittance), tsrc, ref.info, **CPU64)
    _close(carried.evaluate_pressure(inside), ref_p, tol=1e-10)


def test_room_matrix_matches_reference():
    jm = jax_icosphere(1.0, 1)
    import jax.numpy as jnp

    from mathaudio_tpu.bem.assembly import _self_angular_rule
    from mathaudio_tpu_torch.bem.assembly import _mesh_tensors

    qp, qw = jm.quad_points(3)
    sr, sw = _self_angular_rule(jm)
    beta = np.random.default_rng(4).uniform(0.0, 0.5, jm.num_elements)
    ref = np.asarray(jax_room._room_matrix(*(jnp.asarray(a) for a in (
        jm.centers, jm.normals, qp, qw, sr, sw)), KA, jnp.asarray(beta)))
    t = _mesh_tensors(surface_mesh_from_numpy(jm.nodes, jm.elements), 3, torch.float64, "cpu")
    for row_block in (0, 48):
        got = room._room_matrix(*t, KA, torch.tensor(beta), row_block)
        assert np.max(np.abs(got.numpy() - ref)) < 1e-12 * np.max(np.abs(ref))


def test_sources_and_points_match_reference():
    from mathaudio_tpu.common.source import CrossoverFilter as JaxCrossoverFilter
    from mathaudio_tpu.common.source import DirectivityPattern as JaxDirectivityPattern
    from mathaudio_tpu_torch.common.source import DirectivityPattern

    for make in ("full_range", "lowpass", "highpass", "bandpass"):
        args = {"full_range": (), "lowpass": (120.0, 4), "highpass": (80.0,),
                "bandpass": (60.0, 2000.0, 3)}[make]
        ref, got = getattr(JaxCrossoverFilter, make)(*args), getattr(CrossoverFilter, make)(*args)
        for f in (20.0, 100.0, 5000.0):
            assert got.amplitude_at_frequency(f) == ref.amplitude_at_frequency(f)
    jsrc = JaxSource(JaxPoint3D(0.5, -1.0, 0.2), JaxDirectivityPattern.cardioid(), 0.8)
    tsrc = Source(Point3D(0.5, -1.0, 0.2), DirectivityPattern.cardioid(), 0.8)
    rng = np.random.default_rng(8)
    for x, y, z in rng.normal(size=(6, 3)):
        assert (tsrc.amplitude_towards(Point3D(x, y, z), 250.0)
                == jsrc.amplitude_towards(JaxPoint3D(x, y, z), 250.0))
    theta, phi = rng.uniform(0, np.pi, 9), rng.uniform(-np.pi, np.pi, 9)
    np.testing.assert_allclose(
        tsrc.directivity.interpolate_array(theta, phi),
        np.asarray(jsrc.directivity.interpolate_array(theta, phi)), rtol=1e-14, atol=1e-15)
    a, b = Point3D(1.0, 2.0, -0.5), Point3D(-0.3, 0.1, 2.0)
    ja, jb = JaxPoint3D(1.0, 2.0, -0.5), JaxPoint3D(-0.3, 0.1, 2.0)
    assert (2.0 * a - b).cross(b).normalized().to_array().tolist() == (
        (2.0 * ja - jb).cross(jb).normalized().to_array().tolist())
    assert a.distance_to(b) == ja.distance_to(jb) and a.dot(b) == ja.dot(jb)
