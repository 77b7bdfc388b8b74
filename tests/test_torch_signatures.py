"""Port vs reference: the parameters of the port's public functions.

Each function below takes the reference's parameters (mathaudio_tpu, the
same module path): the same names in the same order with the same defaults,
so that a call written for the reference binds the same way; the port may
add keyword-only parameters after them (``device``). Values the port does
not run yet raise a ValueError that names the slice of the port that brings
them. The node-major sweep is called with the keyword set of the reference's
own bench (bench.py ``run``) and matches the reference in float64 on the
CPU; the ``force`` of the BEM pairwise sums keeps the reference's meaning.
Every name a reference package ``__init__`` re-exports resolves on the
port's package, or stands in a table of unported names with its slice.
"""

import ast
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.fem.assembly as jax_assembly
import mathaudio_tpu.fem.multigrid as jax_multigrid
import mathaudio_tpu.fem.mesh as jax_mesh
import mathaudio_tpu.fem.multigrid_batched as jax_multigrid_batched
import mathaudio_tpu.models.helmholtz_room as jax_helmholtz_room
import mathaudio_tpu.models.room_sweep_nm as jax_room_sweep_nm
import mathaudio_tpu.solvers.preconditioners.basic as jax_basic
import mathaudio_tpu.ops.bem_assembly as jax_ops
import mathaudio_tpu.solvers.direct as jax_direct
import mathaudio_tpu.solvers.krylov as jax_krylov
import mathaudio_tpu_torch.fem.assembly as assembly
import mathaudio_tpu_torch.fem.multigrid as multigrid
import mathaudio_tpu_torch.fem.mesh as mesh
import mathaudio_tpu_torch.fem.multigrid_batched as multigrid_batched
import mathaudio_tpu_torch.models.helmholtz_room as helmholtz_room
import mathaudio_tpu_torch.models.room_sweep_nm as room_sweep_nm
import mathaudio_tpu_torch.solvers.preconditioners.basic as basic
import mathaudio_tpu_torch.ops.bem_assembly as ops
import mathaudio_tpu_torch.solvers.direct as direct
import mathaudio_tpu_torch.solvers.krylov as krylov
from mathaudio_tpu.bem.mesh import icosphere as jax_icosphere
from mathaudio_tpu.fem.multigrid import box_hierarchy as jax_box_hierarchy
from mathaudio_tpu.models import RoomSweepModel as JaxRoomModel
from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel

# (port module, reference module, qualified name)
MODULES = {
    "models.room_sweep_nm": (room_sweep_nm, jax_room_sweep_nm),
    "models.helmholtz_room": (helmholtz_room, jax_helmholtz_room),
    "fem.mesh": (mesh, jax_mesh),
    "solvers.preconditioners.basic": (basic, jax_basic),
    "fem.multigrid_batched": (multigrid_batched, jax_multigrid_batched),
    "fem.multigrid": (multigrid, jax_multigrid),
    "fem.assembly": (assembly, jax_assembly),
    "solvers.direct": (direct, jax_direct),
    "solvers.krylov": (krylov, jax_krylov),
    "ops.bem_assembly": (ops, jax_ops),
}
FUNCTIONS = [
    ("models.room_sweep_nm", "NodeMajorRoomSweep.sweep_fn"),
    ("models.room_sweep_nm", "NodeMajorRoomSweep.sharded_sweep_fn"),
    ("fem.multigrid_batched", "make_dia_mg"),
    ("fem.multigrid_batched", "mg_cycle_batched"),
    ("fem.multigrid", "GeometricMultigrid"),
    ("fem.multigrid", "coarse_embedded"),
    ("fem.assembly", "assemble_stiffness_mass"),
    ("fem.assembly", "assemble_boundary_mass"),
    ("fem.assembly", "assemble_rhs"),
    ("solvers.direct", "complex_solve"),
    ("solvers.direct", "lu_solve"),
    ("solvers.krylov", "gmres"),
    ("ops.bem_assembly", "pairwise_double_layer"),
    ("ops.bem_assembly", "pairwise_bm"),
    ("ops.bem_assembly", "pairwise_mixed"),
    ("ops.bem_assembly", "pairwise_kh"),
    # slice 6a: every FEM-sweep option of the main path
    ("models.room_sweep_nm", "NodeMajorRoomSweep.sweep_fn_jacobi"),
    ("models.room_sweep_nm", "NodeMajorRoomSweep._grid_dims"),
    ("models.room_sweep_nm", "NodeMajorRoomSweep._tp_factors"),
    ("fem.multigrid_batched", "_real_view"),
    ("fem.multigrid_batched", "_prolong_tp"),
    ("fem.multigrid_batched", "_restrict_tp"),
    ("fem.multigrid_batched", "_interp_axis"),
    ("fem.multigrid_batched", "_decimate_axis"),
    ("fem.multigrid_batched", "_prolong_stream"),
    ("fem.multigrid_batched", "_restrict_stream"),
    ("fem.multigrid_batched", "_prolong_stream16"),
    ("fem.multigrid_batched", "_restrict_stream16"),
    ("fem.multigrid_batched", "_prolong_b"),
    ("fem.multigrid_batched", "_restrict_b"),
    ("fem.multigrid_batched", "_coarse_solve_b"),
    ("fem.multigrid", "box_hierarchy"),
    ("fem.multigrid", "rect_hierarchy"),
    ("fem.multigrid", "box_hierarchy_dims"),
    ("fem.multigrid", "structured_prolongation"),
    ("fem.multigrid", "prolongation_1d"),
    ("fem.multigrid", "box_grid_dims"),
    ("fem.multigrid", "transpose_transfer"),
    ("fem.multigrid", "_level_values"),
    ("fem.multigrid", "build_mg_levels"),
    ("fem.multigrid", "build_coarse_inv"),
    ("fem.multigrid", "build_coarse_inv_chain"),
    ("fem.multigrid", "build_mg_params"),
    ("fem.multigrid", "_level_matvec"),
    ("fem.multigrid", "_prolong"),
    ("fem.multigrid", "_restrict"),
    ("fem.multigrid", "_coarse_solve"),
    ("fem.multigrid", "mg_cycle"),
    ("fem.multigrid", "vcycle"),
    ("fem.multigrid", "solve_multigrid"),
    ("fem.assembly", "scatter_ell"),
    ("fem.assembly", "scatter_diag"),
    ("fem.assembly", "HelmholtzAssembler.system_values"),
    ("fem.assembly", "HelmholtzAssembler.apply_dirichlet_values"),
    ("fem.assembly", "HelmholtzAssembler.dirichlet_rhs"),
    ("fem.assembly", "HelmholtzAssembler.operator_from_values"),
    ("fem.assembly", "HelmholtzAssembler.assemble"),
    ("fem.assembly", "HelmholtzAssembler.diagonal_of"),
    ("models.helmholtz_room", "system_values_of"),
    ("models.helmholtz_room", "operator_of"),
    ("models.helmholtz_room", "jacobi_of"),
    ("models.helmholtz_room", "sweep_pressure"),
    ("models.helmholtz_room", "RoomSweepModel.sweep_fn"),
    ("models.helmholtz_room", "RoomSweepModel.sweep"),
    ("models.helmholtz_room", "RoomSweepModel.sweep_spl"),
    ("fem.mesh", "rectangular_mesh_triangles"),
    ("fem.mesh", "unit_square_triangles"),
    ("solvers.preconditioners.basic", "identity_preconditioner"),
    # F4: the reference's XLA forms under their names
    ("ops.bem_assembly", "pairwise_double_layer_xla"),
    ("ops.bem_assembly", "pairwise_bm_xla"),
    ("ops.bem_assembly", "pairwise_kh_xla"),
    ("ops.bem_assembly", "pairwise_mixed_xla"),
]


def _resolve(module, qualname):
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _same_default(a, b):
    """Equal defaults; a config object of each package compares by its
    fields (the two packages' KrylovConfig classes differ)."""
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    return a == b or repr(a) == repr(b)


@pytest.mark.parametrize("where,qualname", FUNCTIONS, ids=[q for _, q in FUNCTIONS])
def test_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    assert [p.name for p in port[:len(ref)]] == [p.name for p in ref]
    for p, r in zip(port, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        assert _same_default(p.default, r.default), (p.name, p.default, r.default)
    extras = port[len(ref):]
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in extras), extras


# The sweeps' state containers: the reference's fields in the reference's
# order (the port may add its own: the static offsets of NodeMajorParams
# lead, MgBuilderLevel's node count closes).
STATES = [
    ("models.room_sweep_nm", "NodeMajorParams"),
    ("models.helmholtz_room", "RoomParams"),
    ("fem.multigrid", "MgLevel"),
    ("fem.multigrid", "MgParams"),
    ("fem.multigrid", "MgBuilderLevel"),
    ("fem.multigrid_batched", "DiaMg"),
    ("fem.multigrid_batched", "DiaLevel"),
]


@pytest.mark.parametrize("where,name", STATES, ids=[n for _, n in STATES])
def test_state_fields_hold_the_reference_order(where, name):
    port_mod, ref_mod = MODULES[where]
    port, ref = getattr(port_mod, name)._fields, getattr(ref_mod, name)._fields
    kept = [f for f in port if f in ref]
    assert kept == list(ref), (port, ref)
    assert set(port) - set(ref) <= {"offsets", "num_nodes"}


# --------------------------------------------------------------------------
# The reference's bench call (bench.py ``run``, nm layout) at n=4.
# --------------------------------------------------------------------------

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
CONFIG = dict(max_iterations=500, tolerance=1e-5, restart=6)
KS = np.linspace(0.55, 2.2, 32)
# bench.py run(): nm.sweep_fn(config, mg_nu=nu, mg_omega=1.0,
# mg_coarse_anchors=min(anchors, n_freq), mg_cycle_type=cycle,
# gmres_orth=orth, mg_transfers=transfers, freq_chunk=freq_chunk,
# mg_nu_post=nu_post, warm_stride=warm_stride, warm_restart=warm_restart,
# warm_interp=warm_interp), with run()'s defaults at a band of 32
BENCH_KEYWORDS = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=min(64, len(KS)),
                      mg_cycle_type="v", gmres_orth="cgs1", mg_transfers="gather", freq_chunk=0,
                      mg_nu_post=None, warm_stride=0, warm_restart=0, warm_interp="linear")


@pytest.fixture(scope="module")
def sweeps():
    jm = jax_box_hierarchy(4, 2)
    jmg = jax_multigrid.GeometricMultigrid(jm, robin_tags=WALLS)
    jnm = jax_room_sweep_nm.NodeMajorRoomSweep(
        JaxRoomModel(jm[0], assembler=jmg.assemblers[0], **ROOM), jmg)
    tm = multigrid.box_hierarchy(4, 2)
    tmg = multigrid.GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu")
    tnm = room_sweep_nm.NodeMajorRoomSweep(
        RoomSweepModel(tm[0], assembler=tmg.assemblers[0], **ROOM), tmg)
    return jnm, tnm


def test_bench_keyword_call_matches_reference(sweeps):
    jnm, tnm = sweeps
    fn = jax.jit(jnm.sweep_fn(JaxKrylovConfig(**CONFIG), **BENCH_KEYWORDS))  # as bench.py runs it
    rp, rits, rconv = (np.asarray(a) for a in fn(jnm.params(), jnp.asarray(KS)))
    p, its, conv = (t.numpy() for t in tnm.sweep_fn(krylov.KrylovConfig(**CONFIG),
                                                    **BENCH_KEYWORDS)(tnm.params(), KS))
    assert p.shape == rp.shape == (len(KS), 2)
    np.testing.assert_array_equal(its, rits)
    np.testing.assert_array_equal(conv, rconv)
    assert conv.all()
    np.testing.assert_allclose(p, rp, rtol=0, atol=1e-9 * np.abs(rp).max())


# --------------------------------------------------------------------------
# Values the port does not run yet: a ValueError naming the slice.
# --------------------------------------------------------------------------


UNPORTED = {
    # values the reference does not know either
    "sweep_unknown_transfers": (lambda nm: nm.sweep_fn(mg_transfers="fft"), "unknown mg_transfers"),
    "sweep_unknown_cycle": (lambda nm: nm.sweep_fn(mg_cycle_type="x"), "unknown multigrid cycle"),
    "cycle_unknown": (lambda nm: multigrid_batched.mg_cycle_batched(None, (), None, cycle="x"),
                      "unknown multigrid cycle"),
    "mg_cycle_unknown": (lambda nm: multigrid.mg_cycle(None, None, cycle="x"),
                         "unknown multigrid cycle"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_value_names_its_slice(sweeps, case):
    call, match = UNPORTED[case]
    with pytest.raises(ValueError, match=match):
        call(sweeps[1])


def test_axis_name_runs_the_sharded_solve():
    """The reference's ``axis_name`` runs: on a one-rank gloo group the
    sharded GMRES gives the unsharded answer."""
    from _torch_parallel_ranks import one_rank_group

    a, b = torch.eye(2, dtype=torch.complex128) * 2.0, torch.ones(2, dtype=torch.complex128)
    with one_rank_group() as mesh:
        got = krylov.gmres(a, b, axis_name=mesh.get_group("dof"))
    assert bool(got.converged) and torch.equal(got.x, krylov.gmres(a, b).x)


def test_make_dia_mg_checks_offsets_against_levels(sweeps):
    tnm = sweeps[1]
    params = tnm.params()
    ks = torch.tensor(KS[:4])
    anchor = torch.zeros((1, 2, 2), dtype=torch.float64)
    mgp = multigrid_batched.make_dia_mg(params.offsets, params.levels, ks, 0.15, anchor)
    assert len(mgp.cms) == len(params.levels)
    with pytest.raises(ValueError, match="do not match"):
        multigrid_batched.make_dia_mg(params.offsets * 2, params.levels, ks, 0.15, anchor)
    with pytest.raises(ValueError, match="do not match"):
        multigrid_batched.make_dia_mg(((0, 1),), params.levels[:1], ks, 0.15, anchor)


def test_coarse_embedded_takes_the_reference_call(sweeps):
    """coarse_embedded(builder, k) with the reference's scalar k and its
    default robin_coeff=0.0 gives the reference's (2Nc, 2Nc) operator."""
    jnm, tnm = sweeps
    got = multigrid.coarse_embedded(tnm.params().mg_builder, 1.3)
    want = np.asarray(jax_multigrid.coarse_embedded(jnm.mg.builder, 1.3))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    batch = multigrid.coarse_embedded(tnm.params().mg_builder, torch.tensor([1.3, 1.7]),
                                      torch.tensor([0.2j, 0.2j]))
    assert tuple(batch.shape) == (2,) + want.shape


def test_assembly_dtype_defaults_and_device_keyword():
    mesh = multigrid.box_hierarchy(2, 1)[0]
    csr, k_vals, m_vals, _ = assembly.assemble_stiffness_mass(mesh, device="cpu")
    assert k_vals.dtype == torch.float32 and k_vals.device.type == "cpu"
    b = assembly.assemble_boundary_mass(mesh, 1, csr, None, torch.float64, device="cpu")
    assert b.dtype == torch.float64 and b.shape == (csr.nnz,)
    rhs = assembly.assemble_rhs(mesh, lambda x: x[..., 0], device="cpu")
    assert rhs.dtype == torch.float32 and rhs.shape == (mesh.num_nodes,)


@pytest.mark.parametrize("method", ["auto", "native", "embed", "qr"])
@pytest.mark.parametrize("shape", [(), (3,)], ids=["single", "batched"])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_direct_solve_methods(method, shape, rhs):
    rng = np.random.default_rng(5)
    n = 6
    a = rng.normal(size=shape + (n, n)) + 1j * rng.normal(size=shape + (n, n)) + 4 * np.eye(n)
    b = rng.normal(size=shape + ((n,) if rhs == "vector" else (n, 2))) + 0j
    want = np.linalg.solve(a, b[..., None])[..., 0] if rhs == "vector" else np.linalg.solve(a, b)
    for fn in (direct.complex_solve, direct.lu_solve):
        got = fn(torch.tensor(a), torch.tensor(b), method=method)
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    if not shape:  # the reference solves one system per call
        ref = jax_direct.lu_solve(jnp.asarray(a), jnp.asarray(b), method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_direct_solve_takes_any_method_as_the_reference():
    """The reference sends a method it does not name to its real embedding
    and rejects none: neither does the port, which solves natively."""
    a = np.array([[2.0 + 1j, 0.5], [0.25j, 3.0]])
    b = np.array([1.0 + 0j, 2.0 - 1j])
    got = direct.complex_solve(torch.tensor(a), torch.tensor(b), "qr")
    ref = jax_direct.complex_solve(jnp.asarray(a), jnp.asarray(b), "qr")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-14)


# --------------------------------------------------------------------------
# ``force`` of the BEM pairwise sums on the CPU.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bem_inputs():
    """Icosphere subdiv 1 (80 elements), order-3 quadrature, and 24
    exterior points, float64 numpy."""
    mesh = jax_icosphere(1.0, 1)
    qp, qw = mesh.quad_points(3)
    rng = np.random.default_rng(11)
    d = rng.normal(size=(24, 3))
    pts = 2.0 * d / np.linalg.norm(d, axis=1, keepdims=True)
    return mesh.centers, mesh.normals, qp, qw, pts


def _call(name, force, k, x, nx, yq, ny, w, pts, module):
    if name == "pairwise_double_layer":
        return module.pairwise_double_layer(x, yq, ny, w, k, force)
    if name == "pairwise_bm":
        return module.pairwise_bm(x, nx, yq, ny, w, k, force)
    if name == "pairwise_mixed":
        return module.pairwise_mixed(x, nx, yq, ny, w, k, True, force)
    return module.pairwise_kh(pts, yq, ny, w, k, force, True)


def _off_diagonal(a):
    a = np.array(a)
    if a.ndim >= 2 and a.shape[-1] == a.shape[-2]:
        ii = np.arange(a.shape[-1])
        a[..., ii, ii] = 0.0
    return a


PAIRWISE = ["pairwise_double_layer", "pairwise_bm", "pairwise_mixed", "pairwise_kh"]


@pytest.mark.parametrize("name", PAIRWISE)
@pytest.mark.parametrize("force", ["auto", "xla"])
def test_force_runs_the_twin_on_the_cpu_as_the_reference_call(bem_inputs, name, force):
    """A reference-style call (scalar k, positional force) gives the
    reference's planes; on the CPU "auto" and "xla" both run the twin and
    launch nothing."""
    c, n, qp, qw, pts = bem_inputs
    before = dict(ops.LAUNCHES)
    tensors = [torch.tensor(a) for a in (c, n, qp, n, qw, pts)]
    got = _call(name, force, 1.4, *tensors, module=ops)
    want = _call(name, "xla", 1.4, *(jnp.asarray(a) for a in (c, n, qp, n, qw, pts)),
                 module=jax_ops)
    assert ops.LAUNCHES == before
    for g, r in zip(got, want):
        if g is None:  # the reference's planes a port call leaves out
            continue
        assert tuple(g.shape) == np.shape(r)
        np.testing.assert_allclose(_off_diagonal(g.numpy()), _off_diagonal(r), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", PAIRWISE)
def test_force_pallas_needs_the_card(bem_inputs, name):
    c, n, qp, qw, pts = bem_inputs
    tensors = [torch.tensor(a) for a in (c, n, qp, n, qw, pts)]
    with pytest.raises(ValueError, match="needs the card"):
        _call(name, "pallas", torch.tensor([1.4]), *tensors, module=ops)
    with pytest.raises(ValueError, match="unknown force"):
        _call(name, "triton", torch.tensor([1.4]), *tensors, module=ops)


# --------------------------------------------------------------------------
# Slice 3 and the auto-EQ path: the only extras are keyword-only ``device``
# and ``generator``, wherever they sit (before a ``**kwargs``, too).
# --------------------------------------------------------------------------

import mathaudio_tpu.apps.autoeq as jax_autoeq  # noqa: E402
import mathaudio_tpu.dsp.denormals as jax_denormals  # noqa: E402
import mathaudio_tpu.dsp.fir as jax_fir  # noqa: E402
import mathaudio_tpu.dsp.formats as jax_formats  # noqa: E402
import mathaudio_tpu.dsp.iir as jax_iir  # noqa: E402
import mathaudio_tpu.dsp.jax_response as jax_response  # noqa: E402
import mathaudio_tpu.dsp.scan as jax_scan  # noqa: E402
import mathaudio_tpu.optim.de as jax_de  # noqa: E402
import mathaudio_tpu.optim.peq_fit as jax_peq_fit  # noqa: E402
import mathaudio_tpu.optim.recorder as jax_recorder  # noqa: E402
import mathaudio_tpu_torch.apps.autoeq as autoeq  # noqa: E402
import mathaudio_tpu_torch.dsp.denormals as denormals  # noqa: E402
import mathaudio_tpu_torch.dsp.fir as fir  # noqa: E402
import mathaudio_tpu_torch.dsp.formats as formats  # noqa: E402
import mathaudio_tpu_torch.dsp.iir as iir  # noqa: E402
import mathaudio_tpu_torch.dsp.response as response  # noqa: E402
import mathaudio_tpu_torch.dsp.scan as scan  # noqa: E402
import mathaudio_tpu_torch.optim.de as de  # noqa: E402
import mathaudio_tpu_torch.optim.peq_fit as peq_fit  # noqa: E402
import mathaudio_tpu_torch.optim.recorder as recorder  # noqa: E402

SLICE3_MODULES = {
    "dsp.iir": (iir, jax_iir),
    "dsp.scan": (scan, jax_scan),
    "dsp.fir": (fir, jax_fir),
    "dsp.formats": (formats, jax_formats),
    "dsp.denormals": (denormals, jax_denormals),
    "dsp.response": (response, jax_response),  # the reference's dsp/jax_response.py
    "optim.de": (de, jax_de),
    "optim.recorder": (recorder, jax_recorder),
    "optim.peq_fit": (peq_fit, jax_peq_fit),
    "apps.autoeq": (autoeq, jax_autoeq),
}


def _public_callables(ref_module):
    """Every public function and class of the reference module, and every
    public method and classmethod of its classes, by qualified name."""
    names = []
    for name, obj in vars(ref_module).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != ref_module.__name__:
            continue
        if inspect.isfunction(obj):
            names.append(name)
        elif inspect.isclass(obj):
            names.append(name)
            for attr, member in vars(obj).items():
                if attr.startswith("_") or not (inspect.isfunction(member)
                                                or isinstance(member, classmethod)):
                    continue
                names.append(f"{name}.{attr}")
    return sorted(names)


SLICE3_FUNCTIONS = [(where, q) for where, (_, ref) in SLICE3_MODULES.items()
                    for q in _public_callables(ref)]


def test_slice3_covers_every_public_callable():
    assert len(SLICE3_FUNCTIONS) >= 80
    for where, qualname in (("optim.de", "differential_evolution"), ("optim.peq_fit", "fit_peq"),
                            ("dsp.iir", "Biquad.np_log_result"), ("dsp.fir", "FirBank.preamp_gain"),
                            ("optim.recorder", "EvaluationRecorder.record"),
                            ("apps.autoeq", "main"), ("dsp.response", "peq_response_db")):
        assert (where, qualname) in SLICE3_FUNCTIONS


@pytest.mark.parametrize("where,qualname", SLICE3_FUNCTIONS, ids=[f"{w}:{q}" for w, q in SLICE3_FUNCTIONS])
def test_slice3_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = SLICE3_MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    extras = [p for p in port if p.name in ("device", "generator") and p.name not in
              {r.name for r in ref}]
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is None for p in extras), extras
    kept = [p for p in port if p not in extras]
    assert [p.name for p in kept] == [p.name for p in ref]
    for p, r in zip(kept, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        if isinstance(p.default, torch.dtype):  # a torch dtype for the reference's jnp one
            assert p.default == getattr(torch, np.dtype(r.default).name), (p.name, r.default)
        else:
            assert _same_default(p.default, r.default), (p.name, p.default, r.default)


# --------------------------------------------------------------------------
# Slices 7a and 4b: the oracles, the room config/geometry/output layer and
# the two BEM applications. The only extras are keyword-only ``dtype`` and
# ``device``, each defaulting to None (float32 and the GPU).
# --------------------------------------------------------------------------

import mathaudio_tpu.apps.qa_suite_bem as jax_qa_suite_bem  # noqa: E402
import mathaudio_tpu.apps.roomsim_bem as jax_roomsim_bem  # noqa: E402
import mathaudio_tpu.bem.testing as jax_bem_testing  # noqa: E402
import mathaudio_tpu.common.config as jax_common_config  # noqa: E402
import mathaudio_tpu.common.geometry as jax_geometry  # noqa: E402
import mathaudio_tpu.common.output as jax_output  # noqa: E402
import mathaudio_tpu.common.types as jax_common_types  # noqa: E402
import mathaudio_tpu.utils.profiling as jax_profiling  # noqa: E402
import mathaudio_tpu.wave.analytical.solution as jax_solution  # noqa: E402
import mathaudio_tpu.wave.analytical.solutions_1d as jax_solutions_1d  # noqa: E402
import mathaudio_tpu.wave.analytical.solutions_2d as jax_solutions_2d  # noqa: E402
import mathaudio_tpu.wave.analytical.solutions_3d as jax_solutions_3d  # noqa: E402
import mathaudio_tpu.wave.special.bessel as jax_bessel  # noqa: E402
import mathaudio_tpu.wave.special.helmholtz as jax_helmholtz  # noqa: E402
import mathaudio_tpu.wave.special.legendre as jax_legendre  # noqa: E402
import mathaudio_tpu.wave.special.spherical as jax_spherical  # noqa: E402
import mathaudio_tpu.xtypes as jax_xtypes  # noqa: E402
import mathaudio_tpu_torch.apps.qa_suite_bem as qa_suite_bem  # noqa: E402
import mathaudio_tpu_torch.apps.roomsim_bem as roomsim_bem  # noqa: E402
import mathaudio_tpu_torch.bem.testing as bem_testing  # noqa: E402
import mathaudio_tpu_torch.common.config as common_config  # noqa: E402
import mathaudio_tpu_torch.common.geometry as geometry  # noqa: E402
import mathaudio_tpu_torch.common.output as output  # noqa: E402
import mathaudio_tpu_torch.common.types as common_types  # noqa: E402
import mathaudio_tpu_torch.utils.profiling as profiling  # noqa: E402
import mathaudio_tpu_torch.wave.analytical.solution as solution  # noqa: E402
import mathaudio_tpu_torch.wave.analytical.solutions_1d as solutions_1d  # noqa: E402
import mathaudio_tpu_torch.wave.analytical.solutions_2d as solutions_2d  # noqa: E402
import mathaudio_tpu_torch.wave.analytical.solutions_3d as solutions_3d  # noqa: E402
import mathaudio_tpu_torch.wave.special.bessel as bessel  # noqa: E402
import mathaudio_tpu_torch.wave.special.helmholtz as helmholtz  # noqa: E402
import mathaudio_tpu_torch.wave.special.legendre as legendre  # noqa: E402
import mathaudio_tpu_torch.wave.special.spherical as spherical  # noqa: E402
import mathaudio_tpu_torch.xtypes as port_xtypes  # noqa: E402

SLICE_7A_4B_MODULES = {
    "wave.special.bessel": (bessel, jax_bessel),
    "wave.special.spherical": (spherical, jax_spherical),
    "wave.special.legendre": (legendre, jax_legendre),
    "wave.special.helmholtz": (helmholtz, jax_helmholtz),
    "wave.analytical.solution": (solution, jax_solution),
    "wave.analytical.solutions_1d": (solutions_1d, jax_solutions_1d),
    "wave.analytical.solutions_2d": (solutions_2d, jax_solutions_2d),
    "wave.analytical.solutions_3d": (solutions_3d, jax_solutions_3d),
    "common.types": (common_types, jax_common_types),
    "common.geometry": (geometry, jax_geometry),
    "common.config": (common_config, jax_common_config),
    "common.output": (output, jax_output),
    "utils.profiling": (profiling, jax_profiling),
    "bem.testing": (bem_testing, jax_bem_testing),
    "apps.roomsim_bem": (roomsim_bem, jax_roomsim_bem),
    "apps.qa_suite_bem": (qa_suite_bem, jax_qa_suite_bem),
    "xtypes": (port_xtypes, jax_xtypes),
}
# the reference's xtypes.x64_enabled reads JAX's global x64 flag, which the
# port does not have: its functions take ``dtype`` instead
XTYPES_PORTED = ("default_float", "default_complex", "complex_dtype_for", "real_dtype_for",
                 "is_complex", "wavenumber", "pressure_to_spl", "log_space", "lin_space")
SLICE_7A_4B_FUNCTIONS = [(where, q) for where, (_, ref) in SLICE_7A_4B_MODULES.items()
                         for q in (XTYPES_PORTED if where == "xtypes" else _public_callables(ref))]


def test_slices_7a_4b_cover_every_public_callable():
    assert len(SLICE_7A_4B_FUNCTIONS) >= 130
    for where, qualname in (("wave.analytical.solutions_3d", "sphere_scattering_3d"),
                            ("wave.special.bessel", "bessel_jn_yn_all"),
                            ("common.types", "RoomMesh.to_surface_mesh"),
                            ("common.config", "RoomConfig.to_simulation"),
                            ("common.geometry", "LShapedRoom.generate_adaptive_mesh"),
                            ("bem.testing", "ValidationResult.create"),
                            ("apps.roomsim_bem", "run_bem_simulation"),
                            ("apps.qa_suite_bem", "sphere_case"), ("apps.qa_suite_bem", "main"),
                            ("utils.profiling", "span"), ("xtypes", "log_space")):
        assert (where, qualname) in SLICE_7A_4B_FUNCTIONS
    for where, (port_mod, ref_mod) in SLICE_7A_4B_MODULES.items():
        if where != "xtypes":  # every public callable of the reference exists in the port
            assert all(hasattr(port_mod, q.split(".")[0]) for q in _public_callables(ref_mod))


def _same_default_or_stream(p, r):
    """Equal defaults; a file default (``span``'s ``file=sys.stderr``) is
    the interpreter's standard error in both, whatever object it was when
    each module was imported."""
    if hasattr(r.default, "write"):
        return hasattr(p.default, "write")
    if isinstance(p.default, torch.dtype):
        return p.default == getattr(torch, np.dtype(r.default).name)
    return _same_default(p.default, r.default)


@pytest.mark.parametrize("where,qualname", SLICE_7A_4B_FUNCTIONS,
                         ids=[f"{w}:{q}" for w, q in SLICE_7A_4B_FUNCTIONS])
def test_slices_7a_4b_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = SLICE_7A_4B_MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    ref_names = {r.name for r in ref}
    extras = [p for p in port if p.name in ("dtype", "device") and p.name not in ref_names]
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is None for p in extras), extras
    kept = [p for p in port if p not in extras]
    assert [p.name for p in kept] == [p.name for p in ref]
    for p, r in zip(kept, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        assert _same_default_or_stream(p, r), (p.name, p.default, r.default)


# --------------------------------------------------------------------------
# Slice 5a: the single-level FMM, the octree, the linear operators, the CSR
# and ELL containers, ILU(0) and its native factorization, the FMM field
# evaluation and the roomsim FMM tier. The extras are keyword-only ``dtype``
# and ``device``, each defaulting to None.
# --------------------------------------------------------------------------

import mathaudio_tpu.bem.fmm as jax_fmm  # noqa: E402
import mathaudio_tpu.bem.octree as jax_octree  # noqa: E402
import mathaudio_tpu.bem.postprocess as jax_postprocess  # noqa: E402
import mathaudio_tpu.native as jax_native  # noqa: E402
import mathaudio_tpu.solvers.operators as jax_operators  # noqa: E402
import mathaudio_tpu.solvers.preconditioners.ilu as jax_ilu  # noqa: E402
import mathaudio_tpu.solvers.sparse as jax_sparse  # noqa: E402
import mathaudio_tpu_torch.bem.fmm as port_fmm  # noqa: E402
import mathaudio_tpu_torch.bem.octree as port_octree  # noqa: E402
import mathaudio_tpu_torch.bem.postprocess as port_postprocess  # noqa: E402
import mathaudio_tpu_torch.native as port_native  # noqa: E402
import mathaudio_tpu_torch.solvers.operators as port_operators  # noqa: E402
import mathaudio_tpu_torch.solvers.preconditioners.ilu as port_ilu  # noqa: E402
import mathaudio_tpu_torch.solvers.sparse as port_sparse  # noqa: E402

SLICE_5A_MODULES = {
    "bem.fmm": (port_fmm, jax_fmm),
    "bem.octree": (port_octree, jax_octree),
    "bem.postprocess": (port_postprocess, jax_postprocess),
    "solvers.operators": (port_operators, jax_operators),
    "solvers.sparse": (port_sparse, jax_sparse),
    "solvers.preconditioners.ilu": (port_ilu, jax_ilu),
    "native": (port_native, jax_native),
    "apps.roomsim_bem": (roomsim_bem, jax_roomsim_bem),
}
# What slice 5a ports of modules whose other parts come later: the MLFMM
# (slice 5b), the colored ILU (slice 6), the native PMIS and coloring
# (slice 6); pytree flattening has no counterpart (the port's operators are
# plain objects), nor has ``_translation_padded``'s ``as_jax`` (the port
# returns a tensor on the build's device).
SLICE_5A_PARTIAL = {
    "bem.fmm": ("unit_sphere_quadrature", "translation_operator", "translation_operator_pairwise",
                "SlfmmOperator", "SlfmmOperator.matvec", "gather_form", "sel_form",
                "build_slfmm_system", "build_slfmm_mixed_system", "build_room_fmm_system",
                "estimate_num_levels", "near_field_csr", "near_ilu_preconditioner",
                "ClusterBlockPreconditioner", "ClusterBlockPreconditioner.from_operator",
                "ClusterBlockPreconditioner.matvec", "_agg_disagg_tensors", "_level_tensors",
                "_near_blocks", "_near_blocks_mixed", "_room_near_blocks",
                "_static_hyper_row_sums", "_static_dlp_row_sums", "_stable_far_orders",
                "_pack_clusters", "_apply_bm_row_factor"),
    "bem.postprocess": ("evaluate_field_fmm",),
    "solvers.preconditioners.ilu": ("ilu0_factor", "IluFixedPoint", "IluFixedPoint.from_csr",
                                    "IluFixedPoint.matvec", "_split_lu"),
    "native": ("ilu0_factor_inplace",),
    "apps.roomsim_bem": ("_solve_room_fmm",),
}
SLICE_5A_FUNCTIONS = [
    (where, q) for where, (_, ref) in SLICE_5A_MODULES.items()
    for q in SLICE_5A_PARTIAL.get(where, [n for n in _public_callables(ref)
                                          if not n.endswith(("tree_flatten", "tree_unflatten"))])
]


def test_slice_5a_covers_its_modules():
    assert len(SLICE_5A_FUNCTIONS) >= 60
    for where, qualname in (("bem.octree", "Octree.interaction_lists"),
                            ("solvers.sparse", "CsrMatrix.to_ell"),
                            ("solvers.sparse", "EllMatrix.operator"),
                            ("solvers.operators", "EllOperator.rmatvec"),
                            ("solvers.operators", "as_matvec")):
        assert (where, qualname) in SLICE_5A_FUNCTIONS
    for where, (port_mod, ref_mod) in SLICE_5A_MODULES.items():
        names = SLICE_5A_PARTIAL.get(where, _public_callables(ref_mod))
        assert all(hasattr(port_mod, q.split(".")[0]) for q in names)


@pytest.mark.parametrize("where,qualname", SLICE_5A_FUNCTIONS,
                         ids=[f"{w}:{q}" for w, q in SLICE_5A_FUNCTIONS])
def test_slice_5a_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = SLICE_5A_MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    ref_names = {r.name for r in ref}
    extras = [p for p in port if p.name in ("dtype", "device") and p.name not in ref_names]
    kept = [p for p in port if p not in extras]
    assert [p.name for p in kept] == [p.name for p in ref]
    for p, r in zip(kept, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        assert _same_default(p.default, r.default), (p.name, p.default, r.default)
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in extras), extras
    if not qualname.startswith("_"):  # private helpers take them required
        assert all(p.default is None for p in extras), extras


# --------------------------------------------------------------------------
# Slice 5b: the multilevel FMM (the MLFMM tree with its mixed-BC build and
# its gather/selection forms, the two-level MLFMM) and the cluster-major
# solve. The extras are keyword-only ``dtype`` and ``device`` as in slice 5a.
# --------------------------------------------------------------------------

import mathaudio_tpu.bem.fmm_chip as jax_fmm_chip  # noqa: E402
import mathaudio_tpu_torch.bem.fmm_chip as port_fmm_chip  # noqa: E402

SLICE_5B_MODULES = {
    "bem.fmm": (port_fmm, jax_fmm),
    "bem.fmm_chip": (port_fmm_chip, jax_fmm_chip),
}
# The reference's other fmm_chip names (Planes, split_planes, join_planes,
# fmm_chip_matvec_fn, fmm_chip_solve_fn, build_on_host) move complex
# tensors as re/im planes for a TPU transport without complex numbers and
# have no counterpart.
SLICE_5B_FUNCTIONS = [("bem.fmm", q) for q in (
    "_sph_harm_matrix", "sphere_interp_matrix", "MlfmmLevel", "MlfmmTreeData",
    "_tree_gather_form", "MlfmmTreeOperator", "MlfmmTreeOperator.matvec",
    "build_mlfmm_tree_system", "_tree_skeleton", "build_mlfmm_tree_mixed_system", "MlfmmData",
    "MlfmmOperator", "MlfmmOperator.matvec", "build_mlfmm_system")] + [
    ("bem.fmm_chip", "fmm_chip_solve_cm_fn")]
# The one deliberate difference: the solve that fmm_chip_solve_cm_fn returns
# takes operator objects and complex tensors, and returns x complex, where
# the reference's takes and returns re/im planes.
SLICE_5B_RETURNED = {
    "fmm_chip_solve_cm_fn": (("op", "pre", "rhs"), ("op_planes", "pre_planes", "rhs_re", "rhs_im")),
}


def test_slice_5b_covers_the_multilevel_fmm():
    assert len(SLICE_5B_FUNCTIONS) == 15
    for where, qualname in SLICE_5B_FUNCTIONS:
        port_mod, ref_mod = SLICE_5B_MODULES[where]
        _resolve(port_mod, qualname), _resolve(ref_mod, qualname)
    names = {q for _, q in SLICE_5A_FUNCTIONS + SLICE_5B_FUNCTIONS}
    ref_classes_and_builders = [n for n in _public_callables(jax_fmm)
                                if n.startswith(("Mlfmm", "build_mlfmm")) and "tree_" not in n]
    assert ref_classes_and_builders and all(n in names for n in ref_classes_and_builders)


@pytest.mark.parametrize("where,qualname", SLICE_5B_FUNCTIONS,
                         ids=[f"{w}:{q}" for w, q in SLICE_5B_FUNCTIONS])
def test_slice_5b_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = SLICE_5B_MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    ref_names = {r.name for r in ref}
    extras = [p for p in port if p.name in ("dtype", "device") and p.name not in ref_names]
    kept = [p for p in port if p not in extras]
    assert [p.name for p in kept] == [p.name for p in ref]
    for p, r in zip(kept, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        assert _same_default(p.default, r.default), (p.name, p.default, r.default)
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in extras), extras
    if not qualname.startswith("_"):  # private helpers take them required
        assert all(p.default is None for p in extras), extras


@pytest.mark.parametrize("factory", list(SLICE_5B_RETURNED))
def test_slice_5b_returned_solve_takes_operators(factory):
    port_params, ref_params = SLICE_5B_RETURNED[factory]
    port = inspect.signature(getattr(port_fmm_chip, factory)()).parameters
    ref = inspect.signature(getattr(jax_fmm_chip, factory)()).parameters
    assert tuple(port) == port_params and tuple(ref) == ref_params


# --------------------------------------------------------------------------
# F4: the reference packages' re-exports resolve on the port's packages.
# --------------------------------------------------------------------------

# Every reference subpackage (each has a port package).
PACKAGES = ("", ".models", ".fem", ".solvers", ".solvers.preconditioners", ".ops", ".bem",
            ".dsp", ".wave", ".wave.analytical", ".wave.special", ".common", ".optim", ".apps",
            ".utils", ".native", ".testfunctions", ".hull", ".parallel")
# Re-exported names whose modules (or parts of them) are later slices.
UNPORTED_EXPORTS = {}
# Re-exported names that have no counterpart on purpose, with the reason.
FMM_PLANES = ("re/im planes for a TPU transport without complex numbers: the port's complex "
              "tensors live on the card, and fmm_chip_solve_cm_fn takes operators")
NO_COUNTERPART_EXPORTS = {
    ".bem": {name: FMM_PLANES for name in (
        "fmm_chip_matvec_fn", "fmm_chip_solve_fn", "join_planes", "split_planes")},
}


def _reexports(package: str):
    """(name, defining module relative to the package root) of every name
    the reference package's ``__init__`` imports from its own modules."""
    mod = importlib.import_module("mathaudio_tpu" + package)
    out = []
    for node in ast.parse(inspect.getsource(mod)).body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith("mathaudio_tpu"):
            for alias in node.names:
                out.append((alias.asname or alias.name, node.module[len("mathaudio_tpu"):]))
    return out


EXPORTS = [(package, name, source) for package in PACKAGES
           for name, source in _reexports(package)]


def test_every_reference_package_reexports():
    assert len(EXPORTS) >= 240
    assert ("", "SPEED_OF_SOUND", ".xtypes") in EXPORTS
    assert (".models", "RoomSweepModel", ".models.helmholtz_room") in EXPORTS
    assert (".bem", "uv_sphere", ".bem.mesh") in EXPORTS
    assert (".bem", "cylinder_mesh", ".bem.mesh") in EXPORTS
    assert (".fem", "box_mesh_hexahedra", ".fem.mesh") in EXPORTS
    for table in (UNPORTED_EXPORTS, NO_COUNTERPART_EXPORTS):
        for package, names in table.items():
            assert set(names) <= {n for p, n, _ in EXPORTS if p == package}, package


@pytest.mark.parametrize("package,name,source", EXPORTS,
                         ids=[f"mathaudio_tpu{p}:{n}" for p, n, _ in EXPORTS])
def test_reference_reexport_resolves_on_the_port(package, name, source):
    port_pkg = importlib.import_module("mathaudio_tpu_torch" + package)
    if name in UNPORTED_EXPORTS.get(package, {}):
        assert UNPORTED_EXPORTS[package][name].startswith("slice ")
        assert not hasattr(port_pkg, name), f"{name} is ported: re-export it, drop its row"
        return
    if name in NO_COUNTERPART_EXPORTS.get(package, {}):
        assert NO_COUNTERPART_EXPORTS[package][name]
        assert not hasattr(port_pkg, name), f"{name} has a counterpart: drop its row"
        return
    got = getattr(port_pkg, name)
    if source == package:  # a submodule (``from mathaudio_tpu.solvers import blas``)
        assert inspect.ismodule(got)
        return
    assert got is getattr(importlib.import_module("mathaudio_tpu_torch" + source), name)


def test_bench_imports_resolve_on_the_port():
    """bench.py's own imports, with the package name swapped."""
    from mathaudio_tpu_torch.models import RoomSweepModel as Model
    from mathaudio_tpu_torch.solvers import KrylovConfig as Config

    assert Model is RoomSweepModel and Config is krylov.KrylovConfig


@pytest.mark.parametrize("name", ["pairwise_double_layer_xla", "pairwise_bm_xla",
                                  "pairwise_kh_xla", "pairwise_mixed_xla"])
def test_xla_forms_match_the_reference_at_a_scalar_k(bem_inputs, name):
    c, n, qp, qw, pts = bem_inputs
    x = pts if name == "pairwise_kh_xla" else c
    args = (x, qp, n, qw) if name in ("pairwise_double_layer_xla", "pairwise_kh_xla") else (
        x, n, qp, n, qw)
    extra = (True,) if name == "pairwise_mixed_xla" else ()
    before = dict(ops.LAUNCHES)
    got = getattr(ops, name)(*(torch.tensor(a) for a in args), 1.4, *extra)
    want = getattr(jax_ops, name)(*(jnp.asarray(a) for a in args), 1.4, *extra)
    assert ops.LAUNCHES == before
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert tuple(g.shape) == np.shape(r)
        np.testing.assert_allclose(_off_diagonal(g.numpy()), _off_diagonal(np.asarray(r)),
                                   rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# Slices 6b and 6c: the Krylov family, the vector helpers, the reusable LU,
# the colored ILU, Schwarz and AMG preconditioners with their native set-up,
# the general FEM problem with its boundary conditions, the triangle and tet
# generators of the scattering meshes, the lumped mass, the memory budget and
# the two FEM apps. The extras are keyword-only ``dtype`` and ``device``,
# each defaulting to None.
# --------------------------------------------------------------------------

import mathaudio_tpu.apps.qa_suite_fem as jax_qa_fem  # noqa: E402
import mathaudio_tpu.apps.roomsim_fem as jax_roomsim_fem  # noqa: E402
import mathaudio_tpu.fem.boundary as jax_boundary  # noqa: E402
import mathaudio_tpu.fem.problem as jax_problem  # noqa: E402
import mathaudio_tpu.solvers.blas as jax_blas  # noqa: E402
import mathaudio_tpu.solvers.preconditioners.amg as jax_amg  # noqa: E402
import mathaudio_tpu.solvers.preconditioners.schwarz as jax_schwarz  # noqa: E402
import mathaudio_tpu.utils.memory as jax_memory  # noqa: E402
import mathaudio_tpu_torch.apps.qa_suite_fem as port_qa_fem  # noqa: E402
import mathaudio_tpu_torch.apps.roomsim_fem as port_roomsim_fem  # noqa: E402
import mathaudio_tpu_torch.fem.boundary as port_boundary  # noqa: E402
import mathaudio_tpu_torch.fem.problem as port_problem  # noqa: E402
import mathaudio_tpu_torch.solvers.blas as port_blas  # noqa: E402
import mathaudio_tpu_torch.solvers.preconditioners.amg as port_amg  # noqa: E402
import mathaudio_tpu_torch.solvers.preconditioners.schwarz as port_schwarz  # noqa: E402
import mathaudio_tpu_torch.utils.memory as port_memory  # noqa: E402

SLICE_6_MODULES = {
    "solvers.krylov": (krylov, jax_krylov),
    "solvers.blas": (port_blas, jax_blas),
    "solvers.direct": (direct, jax_direct),
    "solvers.preconditioners.ilu": (port_ilu, jax_ilu),
    "solvers.preconditioners.schwarz": (port_schwarz, jax_schwarz),
    "solvers.preconditioners.amg": (port_amg, jax_amg),
    "native": (port_native, jax_native),
    "fem.mesh": (mesh, jax_mesh),
    "fem.assembly": (assembly, jax_assembly),
    "fem.boundary": (port_boundary, jax_boundary),
    "fem.problem": (port_problem, jax_problem),
    "utils.memory": (port_memory, jax_memory),
    "apps.qa_suite_fem": (port_qa_fem, jax_qa_fem),
    "apps.roomsim_fem": (port_roomsim_fem, jax_roomsim_fem),
}
# What slice 6 ports of modules that other slices share: the quadrilateral
# and hexahedral generators and their bases are held with slices 4c and
# 6c's rest below. ``native`` is held whole: its ``load_native`` raises
# where the reference's returns None after a failed build (no caller of the
# port falls back to Python), as its docstring says.
SLICE_6_PARTIAL = {
    "fem.mesh": ("annular_mesh_triangles", "spherical_shell_mesh_tetrahedra",
                 "circular_mesh_triangles", "Mesh.boundary_nodes"),
    "fem.assembly": ("assemble_lumped_mass",),
}
SLICE_6_FUNCTIONS = [
    (where, q) for where, (_, ref) in SLICE_6_MODULES.items()
    for q in SLICE_6_PARTIAL.get(where, [n for n in _public_callables(ref)
                                         if not n.endswith(("tree_flatten", "tree_unflatten"))])
]


def test_slice_6_covers_its_modules():
    assert len(SLICE_6_FUNCTIONS) >= 70
    for where, qualname in (("solvers.krylov", "qmrcgstab"),
                            ("solvers.krylov", "gmres_pipelined_ghysels"),
                            ("solvers.preconditioners.ilu", "IluColored.from_csr"),
                            ("solvers.preconditioners.amg", "AmgConfig.for_difficult_problems"),
                            ("solvers.preconditioners.schwarz", "BlockJacobi.from_csr"),
                            ("fem.problem", "solve_helmholtz"), ("fem.boundary", "RobinBC.admittance"),
                            ("apps.roomsim_fem", "FemRoomSimulation.run"),
                            ("apps.qa_suite_fem", "sphere_case"), ("utils.memory", "hbm_frequency_batch")):
        assert (where, qualname) in SLICE_6_FUNCTIONS
    for where, (port_mod, ref_mod) in SLICE_6_MODULES.items():
        names = SLICE_6_PARTIAL.get(where, _public_callables(ref_mod))
        assert all(hasattr(port_mod, q.split(".")[0]) for q in names)


@pytest.mark.parametrize("where,qualname", SLICE_6_FUNCTIONS,
                         ids=[f"{w}:{q}" for w, q in SLICE_6_FUNCTIONS])
def test_slice_6_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = SLICE_6_MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    ref_names = {r.name for r in ref}
    extras = [p for p in port if p.name in ("dtype", "device") and p.name not in ref_names]
    kept = [p for p in port if p not in extras]
    assert [p.name for p in kept] == [p.name for p in ref]
    for p, r in zip(kept, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        assert _same_default(p.default, r.default), (p.name, p.default, r.default)
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is None
               for p in extras), extras


# --------------------------------------------------------------------------
# Slices 4c and 6c's rest: the quadrilateral BEM meshes and generators, the
# near-pair upgrade, the NC.inp parser and BemConfig; the quadrature rules,
# the bases of every element type, the quad and hex generators, PML and
# refinement. The extras are keyword-only ``dtype`` and ``device``, each
# defaulting to None.
# --------------------------------------------------------------------------

import mathaudio_tpu.bem.assembly as jax_bem_assembly  # noqa: E402
import mathaudio_tpu.bem.io as jax_bem_io  # noqa: E402
import mathaudio_tpu.bem.mesh as jax_bem_mesh  # noqa: E402
import mathaudio_tpu.fem.basis as jax_basis  # noqa: E402
import mathaudio_tpu.fem.pml as jax_pml  # noqa: E402
import mathaudio_tpu.fem.quadrature as jax_quadrature  # noqa: E402
import mathaudio_tpu.fem.refinement as jax_refinement  # noqa: E402
import mathaudio_tpu_torch.bem.assembly as port_bem_assembly  # noqa: E402
import mathaudio_tpu_torch.bem.io as port_bem_io  # noqa: E402
import mathaudio_tpu_torch.bem.mesh as port_bem_mesh  # noqa: E402
import mathaudio_tpu_torch.fem.basis as port_basis  # noqa: E402
import mathaudio_tpu_torch.fem.pml as port_pml  # noqa: E402
import mathaudio_tpu_torch.fem.quadrature as port_quadrature  # noqa: E402
import mathaudio_tpu_torch.fem.refinement as port_refinement  # noqa: E402

SLICE_4C_6C_MODULES = {
    "bem.mesh": (port_bem_mesh, jax_bem_mesh),
    "bem.assembly": (port_bem_assembly, jax_bem_assembly),
    "bem.io": (port_bem_io, jax_bem_io),
    "fem.quadrature": (port_quadrature, jax_quadrature),
    "fem.basis": (port_basis, jax_basis),
    "fem.mesh": (mesh, jax_mesh),
    "fem.refinement": (port_refinement, jax_refinement),
    "fem.pml": (port_pml, jax_pml),
    "ops.bem_assembly": (ops, jax_ops),
}
# What this slice ports of modules that earlier slices share.
SLICE_4C_6C_PARTIAL = {
    "bem.assembly": ("apply_near_pair_upgrade", "_near_pairs", "_near_delta"),
    "fem.mesh": ("rectangular_mesh_quads", "box_mesh_hexahedra", "unit_square_quads",
                 "unit_cube_hexahedra", "Mesh.element_measures", "Mesh.element_centroids"),
    "ops.bem_assembly": ("pairwise_mixed_xla",),
}
SLICE_4C_6C_FUNCTIONS = [
    (where, q) for where, (_, ref) in SLICE_4C_6C_MODULES.items()
    for q in SLICE_4C_6C_PARTIAL.get(where, _public_callables(ref))
]


def test_slice_4c_6c_covers_its_modules():
    assert len(SLICE_4C_6C_FUNCTIONS) >= 50
    for where, qualname in (("bem.mesh", "cube_sphere"), ("bem.mesh", "SurfaceMesh.quad_points_refined"),
                            ("bem.io", "BemConfig.from_file"), ("bem.io", "parse_nc_input_string"),
                            ("fem.quadrature", "hex_rule"), ("fem.basis", "element_tables"),
                            ("fem.refinement", "to_p3"), ("fem.pml", "assemble_pml_values")):
        assert (where, qualname) in SLICE_4C_6C_FUNCTIONS
    for where, (port_mod, ref_mod) in SLICE_4C_6C_MODULES.items():
        names = SLICE_4C_6C_PARTIAL.get(where, _public_callables(ref_mod))
        assert all(hasattr(port_mod, q.split(".")[0]) for q in names)


@pytest.mark.parametrize("where,qualname", SLICE_4C_6C_FUNCTIONS,
                         ids=[f"{w}:{q}" for w, q in SLICE_4C_6C_FUNCTIONS])
def test_slice_4c_6c_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = SLICE_4C_6C_MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    ref_names = {r.name for r in ref}
    extras = [p for p in port if p.name in ("dtype", "device") and p.name not in ref_names]
    kept = [p for p in port if p not in extras]
    assert [p.name for p in kept] == [p.name for p in ref]
    for p, r in zip(kept, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        assert _same_default(p.default, r.default), (p.name, p.default, r.default)
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is None
               for p in extras), extras


# Public names of the reference's modules with no counterpart on purpose,
# and why; (module, WHOLE_MODULE) stands for a module the port does not have.
WHOLE_MODULE = "*"
PYTREE = "JAX pytree registration: the port's operators are plain objects"
PALLAS_BEM = ("the Pallas kernel itself: its counterpart is the hand-written CUDA kernel "
              "kernels/bem_pairwise.cu behind ops/bem_assembly.py's pairwise_*(..., force=\"pallas\")")
NO_COUNTERPART = {
    (where, f"{cls}.{m}"): PYTREE
    for where, classes in (("bem.fmm", ("SlfmmOperator", "MlfmmOperator", "MlfmmTreeOperator",
                                        "ClusterBlockPreconditioner")),
                           ("parallel.spmd", ("ShardedEll", "DeviceSchwarz", "ShardedSystem")),
                           ("solvers.operators", ("DenseOperator", "DiagonalOperator",
                                                  "EllOperator")),
                           ("solvers.preconditioners.ilu", ("IluFixedPoint", "IluColored")),
                           ("solvers.preconditioners.schwarz", ("AdditiveSchwarz",)))
    for cls in classes
    for m in ("tree_flatten", "tree_unflatten")
}
NO_COUNTERPART.update({("bem.fmm_chip", name): FMM_PLANES for name in (
    "Planes", "split_planes", "join_planes", "fmm_chip_matvec_fn", "fmm_chip_solve_fn",
    "build_on_host")})
NO_COUNTERPART[("fem.dia", "dia_matvec_pallas")] = (
    "the Pallas kernel itself: the port's counterpart is the hand-written CUDA kernel "
    "kernels/dia_stencil.cu behind fem/dia.py's dia_stencil")
NO_COUNTERPART.update({("ops.bem_assembly", f"pairwise_{v}_pallas"): PALLAS_BEM
                       for v in ("double_layer", "bm", "mixed", "kh")})
NO_COUNTERPART[("xtypes", "x64_enabled")] = (
    "reads JAX's global x64 flag, which the port does not have: its functions take a dtype")
NO_COUNTERPART[("dsp.jax_response", WHOLE_MODULE)] = (
    "the port's dsp/response.py (renamed, as nothing there is JAX; its signatures are held "
    "with slice 3 above)")
NO_COUNTERPART[("utils.cache", WHOLE_MODULE)] = (
    "JAX's persistent compile cache: the port compiles no XLA programs")

# One resolve case per top-level subpackage of the reference; "root" is the
# package's own __init__ and its top-level modules (xtypes). Each case's
# floor is its count of public names, so that a walk that found fewer fails.
RESOLVE_FLOORS = {"apps": 28, "bem": 134, "common": 82, "dsp": 44, "fem": 97, "hull": 14,
                  "models": 16, "native": 4, "ops": 12, "optim": 30, "parallel": 36,
                  "solvers": 84, "testfunctions": 109, "utils": 8, "wave": 61, "root": 10}
RESOLVE_ANCHORS = {"bem": ("bem.io", "BemConfig.build_problem"),
                   "parallel": ("parallel.fmm_spmd", "sharded_mlfmm_tree_solve_fn"),
                   "native": ("native", "load_native"),
                   "ops": ("ops.bem_assembly", "pairwise_kh"),
                   "root": ("xtypes", "pressure_to_spl")}


def _resolve_case(where: str) -> str:
    top = where.split(".")[0]
    return top if top in RESOLVE_FLOORS else "root"


def _reference_modules(case: str):
    """Paths (below the package) of every reference module of one resolve
    case, its subpackages' ``__init__`` modules included."""
    import pkgutil

    if case == "root":
        root = importlib.import_module("mathaudio_tpu")
        return [""] + [i.name for i in pkgutil.iter_modules(root.__path__) if not i.ispkg]
    pkg = importlib.import_module(f"mathaudio_tpu.{case}")
    return [case] + [i.name.split(".", 1)[1]
                     for i in pkgutil.walk_packages(pkg.__path__, f"mathaudio_tpu.{case}.")]


def _dotted(package: str, where: str) -> str:
    return f"{package}.{where}" if where else package


def test_resolve_cases_cover_the_reference():
    import pkgutil

    root = importlib.import_module("mathaudio_tpu")
    tops = {i.name if i.ispkg else "root" for i in pkgutil.iter_modules(root.__path__)}
    assert tops == set(RESOLVE_FLOORS)
    assert {_resolve_case(where) for where, _ in NO_COUNTERPART} <= set(RESOLVE_FLOORS)
    assert all(reason for reason in NO_COUNTERPART.values())


@pytest.mark.parametrize("case", sorted(RESOLVE_FLOORS))
def test_every_reference_callable_resolves_on_the_port(case):
    """Every public function and class (with its methods) that a reference
    module of ``case`` defines resolves on the port's module of the same
    path, or stands in NO_COUNTERPART with its reason; a listed name that
    resolves is an error too."""
    names, missing = [], []
    for where in _reference_modules(case):
        assert _resolve_case(where) == case, where
        ref_names = _public_callables(importlib.import_module(_dotted("mathaudio_tpu", where)))
        names += [(where, q) for q in ref_names]
        try:
            port_mod = importlib.import_module(_dotted("mathaudio_tpu_torch", where))
        except ModuleNotFoundError as e:
            if e.name != _dotted("mathaudio_tpu_torch", where):
                raise
            missing.append((where, WHOLE_MODULE))
            continue
        assert (where, WHOLE_MODULE) not in NO_COUNTERPART, f"{where} is ported"
        for qualname in ref_names:
            try:
                _resolve(port_mod, qualname)
            except AttributeError:
                missing.append((where, qualname))
            else:
                assert (where, qualname) not in NO_COUNTERPART, f"{where}:{qualname} is ported"
    assert len(names) >= RESOLVE_FLOORS[case], len(names)
    if case in RESOLVE_ANCHORS:
        assert RESOLVE_ANCHORS[case] in names
    listed = [key for key in NO_COUNTERPART if _resolve_case(key[0]) == case]
    assert sorted(missing) == sorted(listed), sorted(set(missing) ^ set(listed))


# --------------------------------------------------------------------------
# Slice 7b: the test-function registry, the convex hull and the four DE
# apps. Every public function and class of these modules, with its methods,
# takes the reference's parameters; the one extra is a keyword-only
# ``device`` defaulting to None (the GPU).
# --------------------------------------------------------------------------

import mathaudio_tpu.apps.benchmark_convergence as jax_benchmark_convergence  # noqa: E402
import mathaudio_tpu.apps.plot_de as jax_plot_de  # noqa: E402
import mathaudio_tpu.apps.plot_functions as jax_plot_functions  # noqa: E402
import mathaudio_tpu.apps.run_de as jax_run_de  # noqa: E402
import mathaudio_tpu.hull.export as jax_hull_export  # noqa: E402
import mathaudio_tpu.hull.quickhull as jax_quickhull  # noqa: E402
import mathaudio_tpu.hull.testdata as jax_hull_testdata  # noqa: E402
import mathaudio_tpu.testfunctions.functions as jax_tf_functions  # noqa: E402
import mathaudio_tpu.testfunctions.registry as jax_tf_registry  # noqa: E402
import mathaudio_tpu_torch.apps.benchmark_convergence as port_benchmark_convergence  # noqa: E402
import mathaudio_tpu_torch.apps.plot_de as port_plot_de  # noqa: E402
import mathaudio_tpu_torch.apps.plot_functions as port_plot_functions  # noqa: E402
import mathaudio_tpu_torch.apps.run_de as port_run_de  # noqa: E402
import mathaudio_tpu_torch.hull.export as port_hull_export  # noqa: E402
import mathaudio_tpu_torch.hull.quickhull as port_quickhull  # noqa: E402
import mathaudio_tpu_torch.hull.testdata as port_hull_testdata  # noqa: E402
import mathaudio_tpu_torch.testfunctions.functions as port_tf_functions  # noqa: E402
import mathaudio_tpu_torch.testfunctions.registry as port_tf_registry  # noqa: E402

SLICE_7B_MODULES = {
    "testfunctions.functions": (port_tf_functions, jax_tf_functions),
    "testfunctions.registry": (port_tf_registry, jax_tf_registry),
    "hull.quickhull": (port_quickhull, jax_quickhull),
    "hull.export": (port_hull_export, jax_hull_export),
    "hull.testdata": (port_hull_testdata, jax_hull_testdata),
    "apps.run_de": (port_run_de, jax_run_de),
    "apps.benchmark_convergence": (port_benchmark_convergence, jax_benchmark_convergence),
    "apps.plot_de": (port_plot_de, jax_plot_de),
    "apps.plot_functions": (port_plot_functions, jax_plot_functions),
}
SLICE_7B_FUNCTIONS = [(where, q) for where, (_, ref) in SLICE_7B_MODULES.items()
                      for q in _public_callables(ref)]


def test_slice_7b_covers_its_modules():
    assert len(SLICE_7B_FUNCTIONS) >= 130
    for where, qualname in (("testfunctions.functions", "lampinen_simplified"),
                            ("testfunctions.registry", "get_function_metadata"),
                            ("hull.quickhull", "ConvexHull3D.surface_area"),
                            ("hull.export", "hull_to_html"), ("hull.testdata", "icosahedron_points"),
                            ("apps.run_de", "main"), ("apps.benchmark_convergence", "run_benchmark"),
                            ("apps.benchmark_convergence", "BenchmarkResult.line"),
                            ("apps.plot_de", "plot_html"), ("apps.plot_functions", "surface_html")):
        assert (where, qualname) in SLICE_7B_FUNCTIONS
    for where, (port_mod, ref_mod) in SLICE_7B_MODULES.items():
        assert _public_callables(port_mod) == _public_callables(ref_mod), where


@pytest.mark.parametrize("where,qualname", SLICE_7B_FUNCTIONS,
                         ids=[f"{w}:{q}" for w, q in SLICE_7B_FUNCTIONS])
def test_slice_7b_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = SLICE_7B_MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    extras = [p for p in port if p.name == "device" and p.name not in {r.name for r in ref}]
    kept = [p for p in port if p not in extras]
    assert [p.name for p in kept] == [p.name for p in ref]
    for p, r in zip(kept, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        assert _same_default(p.default, r.default), (p.name, p.default, r.default)
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is None
               for p in extras), extras


# --------------------------------------------------------------------------
# Slice 8: parallel/ on torch.distributed. Every public function and class
# of the reference's parallel/ modules, with its methods, takes the
# reference's parameters (the mesh is a torch DeviceMesh, an axis a mesh
# axis name or a process group); the extras are keyword-only ``device``
# (the host builders' device) and ``device_type`` (sweep_mesh's), each
# defaulting to None (the GPU). The pytree methods have no counterpart
# (NO_COUNTERPART above).
# --------------------------------------------------------------------------

import mathaudio_tpu.parallel.de as jax_par_de  # noqa: E402
import mathaudio_tpu.parallel.fmm_spmd as jax_par_fmm  # noqa: E402
import mathaudio_tpu.parallel.mesh as jax_par_mesh  # noqa: E402
import mathaudio_tpu.parallel.spmd as jax_par_spmd  # noqa: E402
import mathaudio_tpu_torch.parallel.de as port_par_de  # noqa: E402
import mathaudio_tpu_torch.parallel.fmm_spmd as port_par_fmm  # noqa: E402
import mathaudio_tpu_torch.parallel.mesh as port_par_mesh  # noqa: E402
import mathaudio_tpu_torch.parallel.spmd as port_par_spmd  # noqa: E402

SLICE_8_MODULES = {
    "parallel.mesh": (port_par_mesh, jax_par_mesh),
    "parallel.spmd": (port_par_spmd, jax_par_spmd),
    "parallel.fmm_spmd": (port_par_fmm, jax_par_fmm),
    "parallel.de": (port_par_de, jax_par_de),
}
SLICE_8_FUNCTIONS = [(where, q) for where, (_, ref) in SLICE_8_MODULES.items()
                     for q in _public_callables(ref)
                     if (where, q) not in NO_COUNTERPART]


def test_slice_8_covers_parallel():
    assert len(SLICE_8_FUNCTIONS) >= 30
    for where, qualname in (("parallel.mesh", "sweep_mesh"), ("parallel.spmd", "halo_exchange"),
                            ("parallel.spmd", "DeviceSchwarz.from_csr"),
                            ("parallel.spmd", "sharded_dense_gmres_fn"),
                            ("parallel.fmm_spmd", "ShardedTreeLevel"),
                            ("parallel.fmm_spmd", "sharded_slfmm_solve_fn"),
                            ("parallel.de", "shard_population_eval")):
        assert (where, qualname) in SLICE_8_FUNCTIONS


@pytest.mark.parametrize("where,qualname", SLICE_8_FUNCTIONS,
                         ids=[f"{w}:{q}" for w, q in SLICE_8_FUNCTIONS])
def test_slice_8_signature_is_the_reference(where, qualname):
    port_mod, ref_mod = SLICE_8_MODULES[where]
    port = list(inspect.signature(_resolve(port_mod, qualname)).parameters.values())
    ref = list(inspect.signature(_resolve(ref_mod, qualname)).parameters.values())
    ref_names = {r.name for r in ref}
    extras = [p for p in port if p.name in ("device", "device_type") and p.name not in ref_names]
    kept = [p for p in port if p not in extras]
    assert [p.name for p in kept] == [p.name for p in ref]
    for p, r in zip(kept, ref):
        assert p.kind == r.kind, (p.name, p.kind, r.kind)
        if inspect.isfunction(r.default):  # ``solver=gmres``: each package's own
            assert p.default.__name__ == r.default.__name__, (p.name, p.default, r.default)
        else:
            assert _same_default(p.default, r.default), (p.name, p.default, r.default)
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is None
               for p in extras), extras
