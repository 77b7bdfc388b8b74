"""Port vs reference: the multilevel FMM (bem/fmm.py: the MLFMM tree with its
mixed-BC build, the two-level MLFMM, their gather and selection forms and
preconditioners), the cluster-major solve (bem/fmm_chip.py) and the MLFMM
routes of BemSolver and the QA suite.

Both packages get the same meshes, on the CPU in float64, with numpy inputs
from a seed:

- "tree": an icosphere with 3 subdivisions (N = 1280), max_per_leaf 4,
  separation 1.5, k = 2, tau 1e4: three levels translate (56, 248 and 728
  nodes). Its skeleton (levels, parents, pair lists, near pairs, clusters,
  masks) must be equal element for element; shifts, interpolations,
  translation tables and every other tensor within 1e-12 of max;
- "bm": 2 subdivisions (N = 320), the same clustering, Burton–Miller beta =
  0.5i; "low": N = 320, k = 0.5, separation 2.0 and the default tau 1e8 (the
  stability screen demotes pairs, tests/test_fmm.py's low-frequency case);
- the matvec in scatter, gather and selection form: 1e-12 of max at tau 1e4
  (5e-10 at tau 1e8, where the screened series turns last bits of D and T into
  ~1e-10 of the matvec, as tests/test_torch_fmm.py explains);
- the mixed tree (N = 320, velocity on the upper hemisphere, seeded pressures
  on the lower, beta = 0.5i, a plane wave): operator, rhs and unknown_p;
- the two-level MLFMM (N = 320, max_per_leaf 4: far pairs at both levels), in
  plain and gather form; the cluster-block and near-field ILU preconditioners
  of both MLFMM operators: 1e-10;
- the cluster-major solve against the reference's element-order GMRES on the
  same operator (a tree and an SLFMM one): equal iterations, x within 1e-9;
- BemSolver(assembly=MLFMM) (rigid CBIE and Burton–Miller): pressures within
  1e-9, equal info; the QA suite's mlfmm case at ka 0.5 against the reference's
  recorded run (qa_bem_results/): pressures within 2e-5 (its float32 passes),
  rel_l2 within 1e-4.

The reference computes the near-block quadrature and the static double-layer
row sums in float32; ``reference_in_float64`` (as in tests/test_torch_fmm.py)
runs those passes in float64 while it builds, and
``test_reference_float32_passes`` holds the unmodified reference at 2e-5.

Tests marked ``cuda`` hold the gather form against the selection form on the
card and the card's float64 build against the CPU's (N = 1280, 1e-9).
"""

import contextlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import sph_harm_y

from mathaudio_tpu.bem import fmm as jax_fmm
from mathaudio_tpu.bem import solver as jax_solver
from mathaudio_tpu.bem import types as jax_types
from mathaudio_tpu.bem.incident import plane_wave as jax_plane_wave
from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
from mathaudio_tpu.solvers import gmres as jax_gmres
from mathaudio_tpu_torch.apps import qa_suite_bem as qa
from mathaudio_tpu_torch.bem import assembly, fmm, fmm_chip, solver, types
from mathaudio_tpu_torch.bem.incident import plane_wave
from mathaudio_tpu_torch.convert import boundary_condition_from_numpy, surface_mesh_from_numpy
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

ROOT = Path(__file__).resolve().parents[1]
CPU64 = dict(dtype=torch.float64, device="cpu")
K = 2.0
TREE = dict(max_per_leaf=4, separation_ratio=1.5, stability_tau=1.0e4)


class _Float64Numpy:
    """numpy with ``float32`` reading float64."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


@contextlib.contextmanager
def reference_in_float64():
    """The reference's float32 near-block quadrature and static row sums
    run in float64 (see tests/test_torch_fmm.py)."""
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


def _meshes(subdiv):
    jm = jax_icosphere(1.0, subdiv)
    return jm, surface_mesh_from_numpy(jm.nodes, jm.elements)


@pytest.fixture(scope="module")
def mesh2():
    return _meshes(2)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return 0.0
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


@jax.jit
def _ref_matvec(op, x):
    """The reference operator's matvec, jitted (run eagerly, its first call
    compiles each of its small ops on its own)."""
    return op.matvec(x)


def _ref_mv(op, x):
    return np.asarray(_ref_matvec(op, jnp.asarray(x)))


def _seeded(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _bc(mesh):
    """Velocity on the upper hemisphere, seeded pressures on the lower."""
    upper = mesh.centers[:, 2] >= 0.0
    return np.where(upper, 0, 1).astype(np.int32), np.where(upper, 1.0 + 0.0j, _seeded(len(upper), 5))


def _same(got, want, tol, what):
    """Index tensors equal, values within ``tol`` of max."""
    if want is None:
        assert got is None, what
        return
    if np.issubdtype(np.asarray(want).dtype, np.integer):
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=what)
    else:
        assert _rel(got, want) < tol, what


TREES = {  # name: (subdivisions, build keywords)
    "tree": (3, dict(TREE, k=K)),
    "bm": (2, dict(TREE, k=K, beta=0.5j)),
    "low": (2, dict(max_per_leaf=4, separation_ratio=2.0, k=0.5)),
}
MATVEC_TOL = {"tree": 1e-12, "bm": 1e-12, "low": 5e-10}


@pytest.fixture(scope="module")
def trees(mesh2):
    """{name: (reference operator, port operator, port mesh)}."""
    out = {}
    meshes = {2: mesh2, 3: _meshes(3)}
    with reference_in_float64():
        for name, (subdiv, kw) in TREES.items():
            jm, tm = meshes[subdiv]
            kw = dict(kw)
            k = kw.pop("k")
            out[name] = (jax_fmm.build_mlfmm_tree_system(jm, k, **kw),
                         fmm.build_mlfmm_tree_system(tm, k, **kw, **CPU64), tm)
    return out


# --------------------------------------------------------------------------
# Spherical harmonics and the grid interpolation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lmax", [0, 6, 17])
def test_sph_harm_is_scipys(lmax):
    dirs, _ = fmm.unit_sphere_quadrature(12)
    rng = np.random.default_rng(3)
    extra = rng.standard_normal((40, 3))
    dirs = np.concatenate([dirs, extra / np.linalg.norm(extra, axis=1, keepdims=True),
                           [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]])
    theta = np.arccos(np.clip(dirs[:, 2], -1.0, 1.0))
    phi = np.arctan2(dirs[:, 1], dirs[:, 0])
    want = np.stack([sph_harm_y(l, m, theta, phi) for l in range(lmax + 1)
                     for m in range(-l, l + 1)], axis=1)
    got = fmm._sph_harm_matrix(dirs, lmax)
    assert got.shape == want.shape and np.max(np.abs(got - want)) <= 1e-12
    assert fmm._sph_harm_matrix(dirs, lmax) is got  # memoised


@pytest.mark.parametrize("orders", [(6, 10), (10, 6)], ids=["up", "down"])
def test_sphere_interp_matrix(orders):
    a, wa = fmm.unit_sphere_quadrature(orders[0])
    b, _ = fmm.unit_sphere_quadrature(orders[1])
    u = fmm.sphere_interp_matrix(a, wa, b, 6)
    assert np.max(np.abs(u - jax_fmm.sphere_interp_matrix(a, wa, b, 6))) <= 1e-12
    # exact on the band (tests/test_fmm.py:140-153)
    assert np.max(np.abs(u @ fmm._sph_harm_matrix(a, 6) - fmm._sph_harm_matrix(b, 6))) < 1e-12


# --------------------------------------------------------------------------
# The tree: skeleton, tables, matvec
# --------------------------------------------------------------------------


def test_tree_translates_at_three_levels(trees):
    ref, port, _ = trees["tree"]
    assert len(port.data.levels) == len(ref.data.levels) == 3
    assert [int(lv.parent.shape[0]) for lv in port.data.levels] == [56, 248, 728]
    assert all(int(lv.trans_op.shape[0]) > 0 for lv in port.data.levels)
    top = port.data.levels[0]
    assert top.shift_up.shape == (56, 0) and top.interp_up.shape[0] == 0
    assert not bool(top.parent.any())


@pytest.mark.parametrize("level", [0, 1, 2])
def test_tree_level_is_the_references(trees, level):
    ref, port, _ = trees["tree"]
    want, got = ref.data.levels[level], port.data.levels[level]
    for field in want._fields:
        _same(getattr(got, field), getattr(want, field), 1e-12, field)


@pytest.mark.parametrize("name", ["tree", "bm", "low"])
def test_tree_data_is_the_references(trees, name):
    ref, port, _ = trees[name]
    assert port.n == ref.n
    for field in ref.data._fields:
        if field != "levels":
            _same(getattr(port.data, field), getattr(ref.data, field), 1e-12, field)
    assert len(port.data.levels) == len(ref.data.levels)
    for want, got in zip(ref.data.levels, port.data.levels):
        for field in want._fields:
            _same(getattr(got, field), getattr(want, field), 1e-12, field)


@pytest.mark.parametrize("form", ["scatter", "gather", "sel"])
@pytest.mark.parametrize("name", ["tree", "bm", "low"])
def test_tree_matvec_is_the_references(trees, name, form):
    ref, port, _ = trees[name]
    x = _seeded(port.n, 1)
    want = _ref_mv(ref, x)
    op = {"scatter": lambda o: o, "gather": fmm.gather_form, "sel": fmm.sel_form}[form](port)
    assert _rel(op.matvec(torch.as_tensor(x)), want) < MATVEC_TOL[name]
    ref_op = {"scatter": lambda o: o, "gather": jax_fmm.gather_form,
              "sel": jax_fmm.sel_form}[form](ref)
    for field in ("near_of_tgt", "elem_pos"):
        _same(getattr(op.data, field), getattr(ref_op.data, field), 0.0, field)
    for want_lv, got_lv in zip(ref_op.data.levels, op.data.levels):
        for field in ("trans_of_tgt", "children_idx", "children_mask", "sel"):
            _same(getattr(got_lv, field), getattr(want_lv, field), 1e-300, field)


def test_low_frequency_demotes_and_stays_accurate(trees):
    """tests/test_fmm.py:171-184: pairs the screen demotes go to exact near
    blocks; the matvec stays within 0.05 of the dense one."""
    _, port, tm = trees["low"]
    assert port.data.near_b.shape[0] > port.data.clusters.shape[0]
    a = assembly.assemble_collocation_matrix(tm, 0.5, **CPU64)
    x = torch.as_tensor(_seeded(port.n, 1))
    want = a @ x
    assert float(torch.linalg.vector_norm(port.matvec(x) - want)
                 / torch.linalg.vector_norm(want)) < 0.05


def test_reference_float32_passes(mesh2, trees):
    """The unmodified reference (float32 near-block quadrature and static
    row sums) against the port's float64 ones."""
    jm, _ = mesh2
    kw = dict(TREES["bm"][1])
    ref = jax_fmm.build_mlfmm_tree_system(jm, kw.pop("k"), **kw)
    port = trees["bm"][1]
    x = _seeded(port.n, 1)
    assert 1e-9 < _rel(port.matvec(torch.as_tensor(x)), _ref_mv(ref, x)) < 2e-5
    assert 1e-9 < _rel(port.data.near_blocks, ref.data.near_blocks) < 2e-5


def test_tree_cast_and_execution_form(trees):
    port = trees["bm"][1]
    sel = fmm.sel_form(port)
    c64 = sel.to(torch.complex64)
    assert c64.data.t_tensor.dtype == torch.complex64 and c64.data.quad_w.dtype == torch.float32
    lv = c64.data.levels[-1]
    assert lv.trans_op.dtype == torch.complex64 and lv.sel.dtype == torch.float32
    assert lv.children_mask.dtype == torch.float32 and lv.trans_src.dtype == torch.int64
    x = torch.as_tensor(_seeded(port.n, 1))
    assert _rel(c64.matvec(x.to(torch.complex64)), port.matvec(x)) < 1e-5
    run = fmm.execution_form(port, torch.float32)  # on the CPU: cast, scatter form kept
    assert isinstance(run, fmm.MlfmmTreeOperator) and run.data.elem_pos is None
    assert run.data.levels[0].trans_op.dtype == torch.complex64


# --------------------------------------------------------------------------
# The mixed tree and the two-level MLFMM
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed(mesh2):
    jm, tm = mesh2
    bc_types, values = _bc(jm)
    kw = dict(TREE, beta=0.5j)
    with reference_in_float64():
        ref = jax_fmm.build_mlfmm_tree_mixed_system(
            jm, K, jax_types.BoundaryCondition(bc_types, values),
            incident=jax_plane_wave((0.0, 0.0, 1.0)), **kw)
    port = fmm.build_mlfmm_tree_mixed_system(
        tm, K, boundary_condition_from_numpy(bc_types, values),
        incident=plane_wave((0.0, 0.0, 1.0)), **kw, **CPU64)
    return ref, port


def test_mixed_tree_is_the_references(mixed):
    (ref_op, ref_rhs, ref_up), (op, rhs, up) = mixed
    for field in ref_op.data._fields:
        if field != "levels":
            _same(getattr(op.data, field), getattr(ref_op.data, field), 1e-12, field)
    x = _seeded(op.n, 2)
    want = _ref_mv(ref_op, x)
    assert _rel(op.matvec(torch.as_tensor(x)), want) < 1e-12
    assert _rel(fmm.gather_form(op).matvec(torch.as_tensor(x)), want) < 1e-12
    assert _rel(rhs, ref_rhs) < 1e-12
    np.testing.assert_array_equal(up, np.asarray(ref_up))
    assert 0 < int(up.sum()) < op.n


@pytest.fixture(scope="module")
def two_level(mesh2):
    jm, tm = mesh2
    with reference_in_float64():
        ref = jax_fmm.build_mlfmm_system(jm, K, **TREE)
    return ref, fmm.build_mlfmm_system(tm, K, **TREE, **CPU64)


def test_two_level_data_is_the_references(two_level):
    ref, port = two_level
    for field in ref.data.leaf._fields:
        _same(getattr(port.data.leaf, field), getattr(ref.data.leaf, field), 1e-12, field)
    for field in ref.data._fields[1:]:
        _same(getattr(port.data, field), getattr(ref.data, field), 1e-12, field)
    # far pairs at both levels
    assert int((port.data.coarse_d.abs().sum(-1) > 0).sum()) > 0
    assert int((port.data.leaf.d_tensor.abs().sum(-1) > 0).sum()) > 0


@pytest.mark.parametrize("form", ["plain", "gather"])
def test_two_level_matvec_is_the_references(two_level, form):
    ref, port = two_level
    op = fmm.gather_form(port) if form == "gather" else port
    assert (op.data.coarse_elem_pos is None) == (form == "plain")
    x = _seeded(port.n, 3)
    assert _rel(op.matvec(torch.as_tensor(x)), _ref_mv(ref, x)) < 1e-12
    if form == "gather":
        ref_g = jax_fmm.gather_form(ref).data
        _same(op.data.coarse_elem_pos, ref_g.coarse_elem_pos, 0.0, "coarse_elem_pos")
        _same(op.data.leaf.near_of_tgt, ref_g.leaf.near_of_tgt, 0.0, "near_of_tgt")
        assert fmm.sel_form(port).data.coarse_elem_pos is not None
        c64 = op.to(torch.complex64)
        assert c64.data.leaf.t_tensor.dtype == c64.data.coarse_t.dtype == torch.complex64
        assert _rel(c64.matvec(torch.as_tensor(x).to(torch.complex64)),
                    op.matvec(torch.as_tensor(x))) < 1e-5


@pytest.mark.parametrize("which", ["tree", "two_level"])
def test_preconditioners_of_the_mlfmm_operators(trees, two_level, which):
    ref, port = (trees["bm"][:2] if which == "tree" else two_level)
    r = _seeded(port.n, 4)
    with reference_in_float64():
        want = np.asarray(jax_fmm.near_ilu_preconditioner(ref).matvec(jnp.asarray(r)))
    assert _rel(fmm.near_ilu_preconditioner(port).matvec(torch.as_tensor(r)), want) < 1e-10
    want = np.asarray(jax_fmm.ClusterBlockPreconditioner.from_operator(ref).matvec(jnp.asarray(r)))
    pre = fmm.ClusterBlockPreconditioner.from_operator(port)
    assert _rel(pre.matvec(torch.as_tensor(r)), want) < 1e-10


# --------------------------------------------------------------------------
# The cluster-major solve
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slfmm_op(mesh2):
    jm, tm = mesh2
    kw = dict(max_per_leaf=16, stability_tau=1.0e4, beta=0.5j)
    with reference_in_float64():
        ref = jax_fmm.build_slfmm_system(jm, K, **kw)
    return ref, fmm.build_slfmm_system(tm, K, **kw, **CPU64)


@pytest.mark.parametrize("which", ["tree", "slfmm"])
def test_cluster_major_solve_is_the_references_gmres(trees, slfmm_op, mesh2, which):
    ref, port = trees["bm"][:2] if which == "tree" else slfmm_op
    jm = mesh2[0]
    rhs = np.array(jax_plane_wave((0.0, 0.0, 1.0)).pressure(jnp.asarray(jm.centers), K))
    cfg = dict(max_iterations=200, tolerance=1e-8, restart=20)
    ref_sol = jax_gmres(ref, jnp.asarray(rhs), config=JaxKrylovConfig(**cfg),
                        preconditioner=jax_fmm.ClusterBlockPreconditioner.from_operator(ref))
    solve = fmm_chip.fmm_chip_solve_cm_fn(KrylovConfig(**cfg))
    x, its, conv = solve(fmm.gather_form(port), fmm.ClusterBlockPreconditioner.from_operator(port),
                         torch.as_tensor(rhs))
    assert bool(conv) and bool(ref_sol.converged)
    assert int(its) == int(ref_sol.iterations) > 2
    assert _rel(x, ref_sol.x) < 1e-9
    with pytest.raises(ValueError, match="gather form"):
        solve(port, None, torch.as_tensor(rhs))


# --------------------------------------------------------------------------
# The entry points: BemSolver(assembly=MLFMM) and the QA suite's mlfmm case
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bm", [False, True], ids=["cbie", "burton_miller"])
def test_bem_solver_mlfmm_matches_reference(mesh2, bm):
    jm, tm = mesh2
    kw = dict(assembly="mlfmm", burton_miller=bm, tolerance=1e-10, restart=30)
    jp = jax_solver.BemProblem(jm, jax_types.PhysicsParams.from_wave_number(1.2),
                               jax_plane_wave((0.0, 0.0, 1.0)))
    tp = solver.BemProblem(tm, types.PhysicsParams.from_wave_number(1.2),
                           plane_wave((0.0, 0.0, 1.0)))
    with reference_in_float64():
        ref = jax_solver.BemSolver(jax_types.BemSolverConfig(
            **dict(kw, assembly=jax_types.BemMethod.MLFMM))).solve(jp)
    sol = solver.BemSolver(types.BemSolverConfig(**dict(kw, assembly=types.BemMethod.MLFMM)),
                           **CPU64).solve(tp)
    assert sol.surface_pressure.dtype == torch.complex128
    assert _rel(sol.surface_pressure, ref.surface_pressure) < 1e-9
    assert sol.info == ref.info and sol.info["converged"] and sol.info["iterations"] > 1


def test_qa_mlfmm_case_matches_the_recorded_run(tmp_path):
    """The QA suite's mlfmm case at ka 0.5 (subdivision 2, BemSolver's
    MLFMM route with Burton–Miller) against the reference's recorded x64
    run (qa_bem_results/): the same case, pressures within the reference's
    float32 near-field passes (2e-5), rel_l2 within 1e-4 of its own."""
    got = qa.sphere_case(0.5, 2, str(tmp_path), 0, "mlfmm", **CPU64)
    with open(ROOT / "qa_bem_results" / "sphere_ka0.5_mlfmm.json") as fh:
        rec = json.load(fh)
    assert got.name == rec["name"] == "sphere_scattering_ka0.5_mlfmm"
    assert got.parameters == rec["parameters"]
    assert got.metadata.solver == rec["metadata"]["solver"] == "gmres+mlfmm"
    want = rec["computed"]
    assert _rel(np.asarray(got.computed.pressure_real) + 1j * np.asarray(got.computed.pressure_imag),
                np.asarray(want["pressure_real"]) + 1j * np.asarray(want["pressure_imag"])) < 2e-5
    assert abs(got.metrics.l2_relative / rec["metrics"]["l2_relative"] - 1) <= 1e-4


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tree_on_the_card_matches_the_cpu(trees, cuda_device):
    _, cpu, tm = trees["tree"]
    kw = dict(TREES["tree"][1])
    card = fmm.build_mlfmm_tree_system(tm, kw.pop("k"), **kw, dtype=torch.float64,
                                       device=cuda_device)
    x = torch.as_tensor(_seeded(cpu.n, 1))
    want = cpu.matvec(x)
    for form in (fmm.gather_form, fmm.sel_form):
        assert _rel(form(card).matvec(x.to(cuda_device)).cpu(), want) < 1e-9


@pytest.mark.cuda
def test_gather_and_sel_forms_agree_on_the_card(trees, cuda_device):
    port = trees["tree"][1].to(device=cuda_device)
    x = torch.as_tensor(_seeded(port.n, 1), device=cuda_device)
    gather, sel = fmm.gather_form(port), fmm.sel_form(port)
    assert _rel(sel.matvec(x).cpu(), gather.matvec(x).cpu()) < 1e-12
    g64, s64 = gather.to(torch.complex64), sel.to(torch.complex64)
    x64 = x.to(torch.complex64)
    assert _rel(s64.matvec(x64).cpu(), g64.matvec(x64).cpu()) < 1e-5
