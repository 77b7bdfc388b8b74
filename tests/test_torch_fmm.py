"""Port vs reference: the single-level FMM (bem/fmm.py, bem/octree.py), the
native ILU(0) and its fixed-point apply, the FMM field evaluation and
BemSolver's FMM routes.

Both packages get the same mesh, an icosphere with 2 subdivisions (N = 320)
clustered with max_per_leaf=16 (56 leaves, near and far pairs), at k = 3,
on the CPU in float64, with numpy inputs from a seed. Compared:

- octree leaves, interaction lists and levels: exactly;
- the unit-sphere quadrature: 1e-14; translation operators: 1e-12 of max,
  and the stability screen's far pairs and orders: exactly;
- every SlfmmData tensor of the rigid, Burton–Miller (beta = 0.5i), mixed
  and room builds: 1e-12 of its max;
- the matvec (scatter and gather form), the mixed right-hand side: 1e-12 of
  max at tau = 1e4; at the default tau = 1e8 5e-10 (below);
- near_field_csr from the same data: equal structure and values; the C++
  ILU(0) against the reference's and the port's own Python loop: 1e-12;
  IluFixedPoint and ClusterBlockPreconditioner applies: 1e-10;
- evaluate_field_fmm with and without q_surf: 1e-10;
- BemSolver(assembly=SLFMM), rigid, Burton–Miller, mixed (and mixed MLFMM,
  which the reference routes through the SLFMM): pressures 1e-9 of max,
  equal info (iterations included).

Two things of the reference set how it is compared:

- It computes the near-block quadrature and the static double-layer row
  sums in float32 (a host-speed choice; bem/fmm.py ``_near_blocks``,
  ``_static_dlp_row_sums``); the port computes them in the build
  precision. ``reference_in_float64`` runs the reference with those two
  passes in float64: while it is active, ``np.float32`` inside
  mathaudio_tpu.bem.fmm reads float64 (no file of the reference changes).
  ``test_reference_float32_passes`` holds the unmodified reference's
  float32 blocks and diagonal to the port's at 2e-5 of max.
- At tau = 1e8 the screened translation series has terms up to ~1e8
  (max|D| = 8.7e7 here) that the quadrature cancels to O(1), so the last
  bits in which the two packages' D and T differ (3e-15 of max) come out at
  ~6e-11 of max|Ax|; at tau = 1e4 the same comparison gives 3e-14. The
  matvec is therefore held to 1e-12 at tau = 1e4 and to 5e-10 at tau = 1e8.

A test marked ``cuda`` holds the complex64 gather-form matvec on the card
against the float64 build on the CPU (<= 1e-4 of max).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.bem import fmm as jax_fmm
from mathaudio_tpu.bem import octree as jax_octree
from mathaudio_tpu.bem import postprocess as jax_post
from mathaudio_tpu.bem import solver as jax_solver
from mathaudio_tpu.bem import types as jax_types
from mathaudio_tpu.bem.incident import plane_wave as jax_plane_wave
from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.solvers.preconditioners import ilu as jax_ilu
from mathaudio_tpu.solvers.sparse import CsrMatrix as JaxCsr
from mathaudio_tpu_torch.bem import fmm
from mathaudio_tpu_torch.bem import octree
from mathaudio_tpu_torch.bem import postprocess as post
from mathaudio_tpu_torch.bem import solver, types
from mathaudio_tpu_torch.bem.incident import plane_wave
from mathaudio_tpu_torch.convert import boundary_condition_from_numpy, surface_mesh_from_numpy
from mathaudio_tpu_torch.solvers.preconditioners import ilu
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix

CPU64 = dict(dtype=torch.float64, device="cpu")
K = 3.0
LEAF = 16
TAUS = {"tau1e8": 1.0e8, "tau1e4": 1.0e4}
MATVEC_TOL = {"tau1e8": 5e-10, "tau1e4": 1e-12}


class _Float64Numpy:
    """numpy with ``float32`` reading float64."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


@contextlib.contextmanager
def reference_in_float64():
    """The reference's float32 near-block quadrature and static row sums
    run in float64 (see the module docstring)."""
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


@pytest.fixture(scope="module")
def meshes():
    jm = jax_icosphere(1.0, 2)
    return jm, surface_mesh_from_numpy(jm.nodes, jm.elements)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _seeded(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _bc(mesh):
    """Velocity on the upper hemisphere, seeded pressures on the lower."""
    upper = mesh.centers[:, 2] >= 0.0
    return np.where(upper, 0, 1).astype(np.int32), np.where(upper, 1.0 + 0.0j, _seeded(len(upper), 5))


BUILDS = {  # name: (kind, beta or admittance, tau)
    "rigid_tau1e8": ("rigid", 0.0, 1.0e8),
    "bm_tau1e8": ("rigid", 0.5j, 1.0e8),
    "rigid_tau1e4": ("rigid", 0.0, 1.0e4),
    "bm_tau1e4": ("rigid", 0.5j, 1.0e4),
    "mixed_tau1e4": ("mixed", 0.0, 1.0e4),
    "mixed_bm_tau1e4": ("mixed", 0.5j, 1.0e4),
    "room_tau1e4": ("room", 0.3, 1.0e4),
}


@pytest.fixture(scope="module")
def builds(meshes):
    """{name: (reference build, port build)}; a mixed build is (op, rhs,
    unknown_p)."""
    jm, tm = meshes
    out = {}
    with reference_in_float64():
        for name, (kind, coef, tau) in BUILDS.items():
            kw = dict(max_per_leaf=LEAF, stability_tau=tau)
            if kind == "rigid":
                ref = jax_fmm.build_slfmm_system(jm, K, beta=coef, **kw)
                port = fmm.build_slfmm_system(tm, K, beta=coef, **kw, **CPU64)
            elif kind == "room":
                ref = jax_fmm.build_room_fmm_system(jm, K, admittance=coef, **kw)
                port = fmm.build_room_fmm_system(tm, K, admittance=coef, **kw, **CPU64)
            else:
                bc_types, values = _bc(jm)
                ref = jax_fmm.build_slfmm_mixed_system(
                    jm, K, jax_types.BoundaryCondition(bc_types, values), beta=coef,
                    incident=jax_plane_wave((0.0, 0.0, 1.0)), **kw)
                port = fmm.build_slfmm_mixed_system(
                    tm, K, boundary_condition_from_numpy(bc_types, values), beta=coef,
                    incident=plane_wave((0.0, 0.0, 1.0)), **kw, **CPU64)
            out[name] = (ref, port)
    return out


def _op(build):
    return build[0] if isinstance(build, tuple) else build


# --------------------------------------------------------------------------
# Octree and quadrature
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cloud", ["mesh_centers", "random_points"])
def test_octree_is_the_references(meshes, cloud):
    pts = (meshes[0].centers if cloud == "mesh_centers"
           else np.random.default_rng(3).uniform(-1.0, 2.0, size=(700, 3)))
    ref = jax_octree.Octree.build(pts, max_per_leaf=LEAF)
    got = octree.Octree.build(pts, max_per_leaf=LEAF)
    assert len(got.leaves) == len(ref.leaves)
    for a, b in zip(got.leaves, ref.leaves):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.center, b.center)
        assert a.half == b.half and a.depth == b.depth
    assert [len(lv) for lv in got.levels()] == [len(lv) for lv in ref.levels()]
    for sep in (1.5, 2.0):
        for a, b in zip(got.interaction_lists(sep), ref.interaction_lists(sep)):
            np.testing.assert_array_equal(a, b)


def test_empty_octree_is_one_leaf():
    got = octree.Octree.build(np.zeros((0, 3)))
    assert len(got.leaves) == 1 and len(got.leaves[0].indices) == 0


@pytest.mark.parametrize("order", [0, 3, 12])
def test_unit_sphere_quadrature(order):
    dirs, w = fmm.unit_sphere_quadrature(order)
    rdirs, rw = jax_fmm.unit_sphere_quadrature(order)
    np.testing.assert_allclose(dirs, rdirs, rtol=0, atol=1e-14)
    np.testing.assert_allclose(w, rw, rtol=0, atol=1e-14)


# --------------------------------------------------------------------------
# Translation operators and the stability screen
# --------------------------------------------------------------------------


def test_translation_operators():
    rng = np.random.default_rng(7)
    d_vecs = rng.uniform(-3.0, 3.0, size=(40, 3))
    dirs, _ = fmm.unit_sphere_quadrature(9)
    orders = rng.integers(0, 10, size=40)
    got = fmm.translation_operator(K, d_vecs, dirs, 9, **CPU64)
    assert got.dtype == torch.complex128 and _rel(got, jax_fmm.translation_operator(
        K, d_vecs, dirs, 9)) < 1e-12
    got = fmm.translation_operator_pairwise(K, d_vecs, dirs, 9, orders, **CPU64)
    assert _rel(got, jax_fmm.translation_operator_pairwise(K, d_vecs, dirs, 9, orders)) < 1e-12


@pytest.mark.parametrize("tau", list(TAUS))
def test_stability_screen(meshes, tau):
    jm = meshes[0]
    tree = octree.Octree.build(jm.centers, max_per_leaf=LEAF)
    _, _, cc, rr = fmm._pack_clusters(tree.leaves, jm.centers)
    dist = np.linalg.norm(cc[:, None] - cc[None, :], axis=-1)
    far = dist > 1.5 * (rr[:, None] + rr[None, :])
    for k in (0.3, K):
        got_far, got_orders = fmm._stable_far_orders(k, cc, rr, far, 9, TAUS[tau], **CPU64)
        ref_far, ref_orders = jax_fmm._stable_far_orders(k, cc, rr, far, 9, TAUS[tau])
        np.testing.assert_array_equal(got_far, ref_far)
        np.testing.assert_array_equal(got_orders, ref_orders)
        assert got_far.sum() > 0


# --------------------------------------------------------------------------
# The builds and the matvec
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(BUILDS))
def test_slfmm_data_is_the_references(builds, name):
    ref, port = (_op(b) for b in builds[name])
    assert port.n == ref.n == 320
    for field in ref.data._fields:
        want, got = getattr(ref.data, field), getattr(port.data, field)
        assert (want is None) == (got is None), field
        if want is None:
            continue
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        else:
            assert _rel(got, want) < 1e-12, field
    assert int((_np(port.data.d_tensor) != 0).any(axis=-1).sum()) > 0  # far pairs exist
    assert port.data.near_b.shape[0] > port.data.clusters.shape[0]  # near pairs beyond self


def test_reference_float32_passes(meshes, builds):
    """The unmodified reference (float32 near-block quadrature and static
    row sums) against the port's float64 ones: float32 agreement."""
    jm, _ = meshes
    ref = jax_fmm.build_slfmm_system(jm, K, beta=0.5j, max_per_leaf=LEAF)
    port = builds["bm_tau1e8"][1]
    assert 1e-9 < _rel(port.data.near_blocks, ref.data.near_blocks) < 2e-5
    assert 1e-9 < _rel(port.data.diag_add, ref.data.diag_add) < 2e-5


@pytest.mark.parametrize("form", ["scatter", "gather"])
@pytest.mark.parametrize("name", list(BUILDS))
def test_matvec_is_the_references(builds, name, form):
    ref, port = (_op(b) for b in builds[name])
    x = _seeded(320, 1)
    want = np.asarray(ref.matvec(jnp.asarray(x)))
    op = fmm.gather_form(port) if form == "gather" else port
    assert (op.data.elem_pos is None) == (form == "scatter")
    assert _rel(op.matvec(torch.as_tensor(x)), want) < MATVEC_TOL[name.split("_")[-1]]
    if form == "gather":
        ref_g = np.asarray(jax_fmm.gather_form(ref).data.near_of_tgt)
        np.testing.assert_array_equal(_np(op.data.near_of_tgt), ref_g)
        assert fmm.sel_form(port).data.elem_pos is not None


@pytest.mark.parametrize("name", ["mixed_tau1e4", "mixed_bm_tau1e4"])
def test_mixed_system_rhs(builds, name):
    (_, ref_rhs, ref_up), (_, rhs, up) = builds[name]
    assert _rel(rhs, ref_rhs) < 1e-12
    np.testing.assert_array_equal(up, ref_up)


def test_operator_cast_and_unsupported(builds):
    port = builds["rigid_tau1e4"][1]
    c64 = port.to(torch.complex64)
    assert c64.data.t_tensor.dtype == torch.complex64 and c64.data.quad_w.dtype == torch.float32
    assert c64.data.clusters.dtype == torch.int64
    x = torch.as_tensor(_seeded(320, 1))
    assert _rel(c64.matvec(x.to(torch.complex64)), port.matvec(x)) < 1e-5
    with pytest.raises(TypeError):
        fmm.gather_form(object())
    assert fmm.estimate_num_levels(20000) == jax_fmm.estimate_num_levels(20000)
    assert fmm._MLFMM_STABILITY_TAU == jax_fmm._MLFMM_STABILITY_TAU


def test_agg_phase_f32(meshes):
    jm, tm = meshes
    ref = jax_fmm.build_slfmm_system(jm, K, max_per_leaf=LEAF, stability_tau=1e4,
                                     agg_phase_f32=True)
    port = fmm.build_slfmm_system(tm, K, max_per_leaf=LEAF, stability_tau=1e4,
                                  agg_phase_f32=True, **CPU64)
    assert port.data.t_tensor.dtype == torch.complex64
    assert np.asarray(ref.data.t_tensor).dtype == np.complex64
    assert _rel(port.data.t_tensor, ref.data.t_tensor) < 1e-5
    assert _rel(port.data.s_tensor, ref.data.s_tensor) < 1e-5


# --------------------------------------------------------------------------
# Near field, ILU(0) and the preconditioners
# --------------------------------------------------------------------------


def _port_data_from(ref_data):
    """The reference's SlfmmData carried across as tensors."""
    return fmm.SlfmmData(*(None if v is None else torch.as_tensor(np.array(v))
                           for v in ref_data))


@pytest.fixture(scope="module")
def near_csr(builds):
    ref = builds["room_tau1e4"][0]
    return jax_fmm.near_field_csr(ref.data), fmm.near_field_csr(_port_data_from(ref.data))


def test_near_field_csr(builds, near_csr):
    ref, got = near_csr
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data)
    own = fmm.near_field_csr(builds["room_tau1e4"][1].data)
    np.testing.assert_array_equal(own.indptr, ref.indptr)
    np.testing.assert_array_equal(own.indices, ref.indices)
    assert np.max(np.abs(own.data - ref.data)) / np.max(np.abs(ref.data)) < 1e-12
    assert got.nnz > 320 and got.max_row_nnz() > 16


def test_native_ilu_is_the_references_and_the_python_twin(near_csr):
    ref_csr, csr = near_csr
    got_l, got_u = ilu.ilu0_factor(csr)
    ref_l, ref_u = jax_ilu.ilu0_factor(ref_csr)
    twin_l, twin_u = ilu._ilu0_factor_python(csr)
    for got, want in ((got_l, ref_l), (got_u, ref_u), (got_l, twin_l), (got_u, twin_u)):
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert np.max(np.abs(got.data - want.data)) <= 1e-12 * np.max(np.abs(want.data))


def test_native_ilu_zero_pivot_and_real_data():
    """A zero pivot skips its column update, as the Python twin does;
    real data comes back real."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((30, 30)) * (rng.random((30, 30)) < 0.3) + 4.0 * np.eye(30)
    a[5, 5] = 0.0
    a[5, 2] = a[7, 5] = 1.0
    csr = CsrMatrix.from_dense(a)
    got_l, got_u = ilu.ilu0_factor(csr)
    twin_l, twin_u = ilu._ilu0_factor_python(csr)
    ref_l, ref_u = jax_ilu.ilu0_factor(JaxCsr.from_dense(a))
    assert got_l.data.dtype == np.float64
    for got, want in ((got_l, twin_l), (got_u, twin_u), (got_l, ref_l), (got_u, ref_u)):
        np.testing.assert_allclose(got.data, want.data, rtol=1e-12, atol=1e-14)


def test_csr_and_ell_are_the_references(near_csr):
    ref, got = near_csr
    x = _seeded(320, 2)
    np.testing.assert_allclose(got.matvec(x), ref.matvec(x), rtol=1e-13, atol=0)
    np.testing.assert_array_equal(got.diagonal(), ref.diagonal())
    np.testing.assert_array_equal(got.to_dense(), ref.to_dense())
    for pad in (1, 8):
        np.testing.assert_array_equal(got.to_ell(pad_to_multiple=pad).indices,
                                      ref.to_ell(pad_to_multiple=pad).indices)
        for a, b in zip(got.ell_structure(pad), ref.ell_structure(pad)):
            np.testing.assert_array_equal(a, b)
    ell = got.to_ell().operator(device="cpu")
    want = np.asarray(ref.to_ell().operator().matvec(jnp.asarray(x)))
    assert _rel(ell.matvec(torch.as_tensor(x)), want) < 1e-13
    want_t = np.asarray(ref.to_ell().operator().rmatvec(jnp.asarray(x)))
    assert _rel(ell.rmatvec(torch.as_tensor(x)), want_t) < 1e-13


def test_ilu_fixed_point_apply(near_csr):
    ref_csr, csr = near_csr
    r = _seeded(320, 3)
    want = np.asarray(jax_ilu.IluFixedPoint.from_csr(ref_csr).matvec(jnp.asarray(r)))
    pre = ilu.IluFixedPoint.from_csr(csr, device="cpu")
    assert _rel(pre.matvec(torch.as_tensor(r)), want) < 1e-10
    got64 = pre.to(torch.complex64).matvec(torch.as_tensor(r).to(torch.complex64))
    assert _rel(got64, want) < 1e-5


@pytest.mark.parametrize("name", ["room_tau1e4", "bm_tau1e8"])
def test_near_ilu_and_cluster_block_preconditioners(builds, name):
    ref, port = (_op(b) for b in builds[name])
    r = _seeded(320, 4)
    with reference_in_float64():
        want = np.asarray(jax_fmm.near_ilu_preconditioner(ref).matvec(jnp.asarray(r)))
    assert _rel(fmm.near_ilu_preconditioner(port).matvec(torch.as_tensor(r)), want) < 1e-10
    want = np.asarray(jax_fmm.ClusterBlockPreconditioner.from_operator(ref).matvec(jnp.asarray(r)))
    pre = fmm.ClusterBlockPreconditioner.from_operator(port)
    assert pre.inv.shape == port.data.clusters.shape + port.data.clusters.shape[1:]
    assert _rel(pre.matvec(torch.as_tensor(r)), want) < 1e-10


# --------------------------------------------------------------------------
# Field evaluation and the solver
# --------------------------------------------------------------------------


POINTS = post.generate_sphere_eval_points(2.5, 10, 16)  # 160 points: near and far pairs


@pytest.mark.parametrize("single", [False, True], ids=["double_layer", "with_q_surf"])
def test_evaluate_field_fmm(meshes, single):
    jm, tm = meshes
    p = _seeded(320, 6)
    q = _seeded(320, 7) if single else None
    inc = (jax_plane_wave((0.0, 0.0, 1.0)), plane_wave((0.0, 0.0, 1.0)))
    want = jax_post.evaluate_field_fmm(jm, jnp.asarray(p), POINTS, 2.0, inc[0], max_per_leaf=LEAF,
                                       q_surf=None if q is None else jnp.asarray(q))
    got = post.evaluate_field_fmm(tm, p, POINTS, 2.0, inc[1], max_per_leaf=LEAF, q_surf=q, **CPU64)
    assert got.p_scat.dtype == torch.complex128
    assert _rel(got.p_total, want.p_total) < 1e-10
    scale = np.max(np.abs(np.asarray(want.p_total)))  # the field's own scale, as p_total
    assert np.max(np.abs(_np(got.p_scat) - np.asarray(want.p_scat))) < 1e-10 * scale


FMM_SOLVES = {  # name: (problem kind, assembly, Burton–Miller)
    "rigid_cbie_slfmm": ("rigid", "slfmm", False),
    "rigid_bm_slfmm": ("rigid", "slfmm", True),
    "mixed_bm_slfmm": ("mixed", "slfmm", True),
    "mixed_cbie_mlfmm": ("mixed", "mlfmm", False),
}


def _problems(meshes, kind):
    jm, tm = meshes
    phys = (jax_types.PhysicsParams.from_wave_number(1.2), types.PhysicsParams.from_wave_number(1.2))
    if kind == "rigid":
        return (jax_solver.BemProblem(jm, phys[0], jax_plane_wave((0.0, 0.0, 1.0))),
                solver.BemProblem(tm, phys[1], plane_wave((0.0, 0.0, 1.0))))
    bc_types, values = _bc(jm)
    return (jax_solver.BemProblem(jm, phys[0], None, jax_types.BoundaryCondition(bc_types, values)),
            solver.BemProblem(tm, phys[1], None, boundary_condition_from_numpy(bc_types, values)))


@pytest.mark.parametrize("name", list(FMM_SOLVES))
def test_bem_solver_fmm_matches_reference(meshes, name):
    kind, assembly, bm = FMM_SOLVES[name]
    jp, tp = _problems(meshes, kind)
    kw = dict(burton_miller=bm, tolerance=1e-10, restart=30)
    with reference_in_float64():
        ref = jax_solver.BemSolver(jax_types.BemSolverConfig(
            assembly=jax_types.BemMethod(assembly), **kw)).solve(jp)
    sol = solver.BemSolver(types.BemSolverConfig(assembly=types.BemMethod(assembly), **kw),
                           **CPU64).solve(tp)
    assert sol.surface_pressure.dtype == torch.complex128
    assert _rel(sol.surface_pressure, ref.surface_pressure) < 1e-9
    assert (sol.surface_q is None) == (ref.surface_q is None) == (kind == "rigid")
    if sol.surface_q is not None:
        assert _rel(sol.surface_q, ref.surface_q) < 1e-9
    assert sol.info == ref.info and sol.info["converged"] and sol.info["iterations"] > 1


@pytest.mark.cuda
def test_complex64_matvec_on_the_card(meshes, cuda_device):
    _, tm = meshes
    cpu = fmm.build_slfmm_system(tm, K, beta=0.5j, max_per_leaf=LEAF, stability_tau=1e4, **CPU64)
    card = fmm.build_slfmm_system(tm, K, beta=0.5j, max_per_leaf=LEAF, stability_tau=1e4,
                                  dtype=torch.float64, device=cuda_device)
    c64 = fmm.gather_form(card.to(torch.complex64))
    x = torch.as_tensor(_seeded(320, 1))
    assert _rel(card.to(torch.complex128).matvec(x.to(cuda_device)).cpu(), cpu.matvec(x)) < 1e-12
    assert _rel(c64.matvec(x.to(cuda_device, torch.complex64)).cpu(), cpu.matvec(x)) < 1e-4


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
