"""Port vs reference: the single-vector multigrid and the frequency-major
(vmapped ELL) room sweep.

On the CPU in float64, at n <= 8:

- ``build_mg_params``, ``mg_cycle`` (V, W, F), ``vcycle`` and
  ``solve_multigrid`` against mathaudio_tpu/fem/multigrid.py at n=4 (3
  levels), 1e-12; a (F,) band of wavenumbers gives, lane for lane, the
  single-wavenumber build and cycle; anisotropic ``grid_dims`` and the 2D
  ``rect_hierarchy`` against the reference's transfer stencils and cycle;
- ``HelmholtzAssembler``'s ELL layout and per-frequency methods, and
  ``system_values_of``/``operator_of``/``jacobi_of``, against the
  reference's;
- ``sweep_pressure`` through its four routes (Jacobi; multigrid without
  anchors; anchors gathered per lane; the nested route, chunks of 128
  lanes, F = 256 with 2 anchors) against the reference's vmapped sweep
  at n=4: iterations and converged flags lane for lane, pressures to 1e-9
  of max|p|; ``RoomSweepModel.sweep``/``sweep_spl`` (the Jacobi route)
  likewise;
- the port's vmapped sweep against the port's node-major sweep (V and W,
  CGS2), lane for lane;
- ``room_params_from_numpy`` carries the reference's state across.

The reference's sweeps and cycles run jitted (their vmapped while loops
compile in a few seconds); torch runs on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.fem.multigrid as jax_mg
import mathaudio_tpu.models.helmholtz_room as jax_room
from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
import mathaudio_tpu_torch.fem.multigrid as mg
import mathaudio_tpu_torch.models.helmholtz_room as room
from mathaudio_tpu_torch.convert import room_params_from_numpy
from mathaudio_tpu_torch.fem.assembly import scatter_diag, scatter_ell
from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

torch.set_num_threads(1)

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
CONFIG = dict(max_iterations=60, tolerance=1e-6, restart=8)
KNOBS = dict(mg_nu=1, mg_omega=1.0)


def _build_pair(n, levels):
    jm = jax_mg.box_hierarchy(n, levels)
    jmg = jax_mg.GeometricMultigrid(jm, robin_tags=WALLS)
    jmodel = jax_room.RoomSweepModel(jm[0], assembler=jmg.assemblers[0], **ROOM)
    tm = mg.box_hierarchy(n, levels)
    tmg = mg.GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu")
    tmodel = room.RoomSweepModel(tm[0], assembler=tmg.assemblers[0], **ROOM)
    return jmg, jmodel, tmg, tmodel


@pytest.fixture(scope="module")
def pair():
    return _build_pair(4, 3)


def _random(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _assert_close(got, want, tol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


# --------------------------------------------------------------------------
# The single-vector multigrid.
# --------------------------------------------------------------------------


K, ROBIN = 1.3, -1j * 1.3 * 0.15


@pytest.fixture(scope="module")
def mg_params(pair):
    jmg, _, tmg, _ = pair
    return (jax_mg.build_mg_params(jmg.builder, K, robin_coeff=ROBIN),
            mg.build_mg_params(tmg.builder, K, robin_coeff=ROBIN))


def test_build_mg_params_matches_reference(pair, mg_params):
    _, _, tmg, _ = pair
    jp, tp = mg_params
    assert len(tp.levels) == len(jp.levels) == 2
    for got, want in zip(tp.levels, jp.levels):
        np.testing.assert_array_equal(got.ell_indices.numpy(), np.asarray(want.ell_indices))
        _assert_close(got.ell_values, want.ell_values)
        _assert_close(got.inv_diag, want.inv_diag)
    _assert_close(tp.coarse_inv, jp.coarse_inv, 1e-10)
    _assert_close(mg.build_coarse_inv(tmg.builder, K, ROBIN), jp.coarse_inv, 1e-10)


@pytest.mark.parametrize("cycle", ["v", "w", "f"])
def test_mg_cycle_matches_reference(pair, mg_params, cycle):
    tmg = pair[2]
    jp, tp = mg_params
    r = _random(tmg.meshes[0].num_nodes, 2)
    want = jax.jit(lambda p, r: jax_mg.mg_cycle(p, r, omega=0.8, nu=2, cycle=cycle,
                                                nu_post=1))(jp, jnp.asarray(r))
    want_v = jax.jit(lambda p, r: jax_mg.vcycle(p, r, nu=1))(jp, jnp.asarray(r))
    _assert_close(mg.mg_cycle(tp, torch.tensor(r), omega=0.8, nu=2, cycle=cycle, nu_post=1),
                  want)
    _assert_close(mg.vcycle(tp, torch.tensor(r), nu=1), want_v)


def test_a_band_is_each_lane_s_single_cycle(pair):
    _, _, tmg, _ = pair
    ks = np.array([0.7, 1.3, 1.9])
    band = mg.build_mg_params(tmg.builder, torch.tensor(ks),
                              robin_coeff=torch.tensor(-1j * 0.15 * ks))
    assert tuple(band.levels[0].ell_values.shape[-1:]) == (3,)
    assert tuple(band.coarse_inv.shape[:1]) == (3,)
    r = _random((tmg.meshes[0].num_nodes, 3), 4)
    x = mg.mg_cycle(band, torch.tensor(r), omega=1.0, nu=1, cycle="w").numpy()
    for f, k in enumerate(ks):
        one = mg.build_mg_params(tmg.builder, float(k), robin_coeff=-1j * k * 0.15)
        _assert_close(x[:, f], mg.mg_cycle(one, torch.tensor(r[:, f]), omega=1.0, nu=1,
                                           cycle="w"))


def test_solve_multigrid_matches_reference(pair):
    jmg, _, tmg, _ = pair
    # a damped operator below the first resonance: multigrid alone converges
    jp = jax_mg.build_mg_params(jmg.builder, 0.5, robin_coeff=-0.5j * 0.15)
    tp = mg.build_mg_params(tmg.builder, 0.5, robin_coeff=-0.5j * 0.15)
    b = _random(tmg.meshes[0].num_nodes, 6)
    want, cycles = jax.jit(lambda p, b: jax_mg.solve_multigrid(p, b, tol=1e-8, cycle="f"))(
        jp, jnp.asarray(b))
    got, got_cycles = mg.solve_multigrid(tp, torch.tensor(b), tol=1e-8, cycle="f")
    assert int(got_cycles) == int(cycles) > 1
    _assert_close(got, want, 1e-10)


def test_anisotropic_grid_dims_match_reference():
    jm, jdims = jax_mg.box_hierarchy_dims((4, 2, 2), 2)
    tm, tdims = mg.box_hierarchy_dims((4, 2, 2), 2)
    assert tdims == jdims == [(4, 2, 2), (2, 1, 1)]
    jb = jax_mg.GeometricMultigrid(jm, robin_tags=WALLS, grid_dims=jdims).builder
    tb = mg.GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu",
                               grid_dims=tdims).builder
    for got, want in zip(tb.levels, jb.levels):
        for field in ("p_idx", "p_w", "r_idx", "r_w", "ell_indices", "csr2ell"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
        _assert_close(got.k_vals, want.k_vals)


def test_rect_hierarchy_cycle_matches_reference():
    jm, tm = jax_mg.rect_hierarchy(4, 2), mg.rect_hierarchy(4, 2)
    np.testing.assert_array_equal(tm[1].elements, jm[1].elements)
    jb = jax_mg.GeometricMultigrid(jm, robin_tags=(2,)).builder
    tb = mg.GeometricMultigrid(tm, robin_tags=(2,), dtype=torch.float64, device="cpu").builder
    jp = jax_mg.build_mg_params(jb, 2.0, robin_coeff=-0.2j)
    tp = mg.build_mg_params(tb, 2.0, robin_coeff=-0.2j)
    r = _random(tm[0].num_nodes, 8)
    want = jax.jit(lambda p, r: jax_mg.mg_cycle(p, r, cycle="w"))(jp, jnp.asarray(r))
    _assert_close(mg.mg_cycle(tp, torch.tensor(r), cycle="w"), want)


# --------------------------------------------------------------------------
# The ELL layout and per-frequency values.
# --------------------------------------------------------------------------


def test_assembler_ell_methods_match_reference(pair):
    jmg, _, tmg, _ = pair
    ja, ta = jmg.assemblers[0], tmg.assemblers[0]
    assert ta.ell_width == ja.ell_width
    np.testing.assert_array_equal(ta.ell_indices.numpy(), np.asarray(ja.ell_indices))
    np.testing.assert_array_equal(ta.csr2ell.numpy(), np.asarray(ja.csr2ell))
    coeffs = {1: -0.2j, 4: 0.1 - 0.3j}
    vals = ta.system_values(1.7, coeffs)
    jvals = ja.system_values(1.7, coeffs)
    _assert_close(vals, jvals)
    rng = np.random.default_rng(9)
    constrained = rng.random(ta.num_nodes) < 0.2
    g = np.where(constrained, rng.normal(size=ta.num_nodes), 0.0)
    rhs = _random(ta.num_nodes, 10)
    dvals = ta.apply_dirichlet_values(vals, torch.tensor(constrained))
    jdvals = ja.apply_dirichlet_values(jvals, jnp.asarray(constrained))
    _assert_close(dvals, jdvals)
    _assert_close(ta.dirichlet_rhs(dvals, torch.tensor(rhs), torch.tensor(constrained),
                                   torch.tensor(g)),
                  ja.dirichlet_rhs(jdvals, jnp.asarray(rhs), jnp.asarray(constrained),
                                   jnp.asarray(g)))
    op, avals = ta.assemble(1.7, coeffs, torch.tensor(constrained))
    jop, _ = ja.assemble(1.7, coeffs, jnp.asarray(constrained))
    x = _random(ta.num_nodes, 11)
    _assert_close(op.matvec(torch.tensor(x)), jop.matvec(jnp.asarray(x)))
    _assert_close(ta.diagonal_of(avals), ja.diagonal_of(jdvals))
    _assert_close(scatter_ell(vals, ta.csr2ell, ta.num_nodes, ta.ell_width),
                  ja.operator_from_values(jvals).values)
    _assert_close(scatter_diag(vals, ta.row_of_slot, ta.col_of_slot, ta.num_nodes),
                  ja.diagonal_of(jvals))


def test_room_value_helpers_match_reference(pair):
    _, jmodel, _, tmodel = pair
    jp, tp = jmodel.params(), tmodel.params()
    vals = room.system_values_of(tp, 1.1, 0.15)
    jvals = jax_room.system_values_of(jp, 1.1, 0.15)
    _assert_close(vals, jvals)
    n, w = tmodel.num_nodes, tmodel.ell_width
    _assert_close(room.operator_of(tp, vals, n, w).values,
                  jax_room.operator_of(jp, jvals, n, w).values)
    _assert_close(room.jacobi_of(tp, vals, n), jax_room.jacobi_of(jp, jvals, n))


# --------------------------------------------------------------------------
# The vmapped sweep, every route.
# --------------------------------------------------------------------------

# route: (band size, anchors, builder?, cycle)
ROUTES = {
    "jacobi": (8, 0, False, "v"),
    "mg_per_frequency": (8, 0, True, "v"),
    "mg_anchors_per_lane": (8, 3, True, "w"),
    "mg_anchor_chunks": (256, 2, True, "v"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_sweep_pressure_matches_reference(pair, route):
    jmg, jmodel, tmg, tmodel = pair
    nf, anchors, with_mg, cycle = ROUTES[route]
    ks = np.linspace(0.55, 2.2, nf)
    cfg = dict(CONFIG, restart=30) if not with_mg else CONFIG
    kw = dict(KNOBS, mg_coarse_anchors=anchors, mg_cycle_type=cycle)
    jfn = jax.jit(jmodel.sweep_fn(JaxKrylovConfig(**cfg),
                                  mg_builder=jmg.builder if with_mg else None, **kw))
    rp, rits, rconv = (np.asarray(a) for a in jfn(jmodel.params(), jnp.asarray(ks)))
    fn = tmodel.sweep_fn(KrylovConfig(**cfg), mg_builder=tmg.builder if with_mg else None, **kw)
    p, its, conv = (t.numpy() for t in fn(tmodel.params(), ks))
    assert p.shape == rp.shape == (nf, 2)
    np.testing.assert_array_equal(its, rits)
    np.testing.assert_array_equal(conv, rconv)
    assert conv.all()
    np.testing.assert_allclose(p, rp, rtol=0, atol=1e-9 * np.abs(rp).max())
    if not with_mg:  # RoomSweepModel.sweep / sweep_spl run this route
        p2, its2, _ = tmodel.sweep(ks, KrylovConfig(**cfg))
        spl, its3, _ = tmodel.sweep_spl(ks, KrylovConfig(**cfg))
        np.testing.assert_array_equal(its2.numpy(), rits)
        np.testing.assert_array_equal(its3.numpy(), rits)
        np.testing.assert_allclose(p2.numpy(), rp, rtol=0, atol=1e-9 * np.abs(rp).max())
        np.testing.assert_allclose(spl.numpy(), np.asarray(jax_room.pressure_to_spl(
            jnp.abs(jnp.asarray(rp)))), rtol=0, atol=1e-7)


def test_room_params_from_numpy_reproduces_reference(pair):
    _, jmodel, _, tmodel = pair
    tree = jax.tree_util.tree_map(np.asarray, jmodel.params())
    params = room_params_from_numpy(tree, device="cpu", dtype=torch.float64)
    for field in room.RoomParams._fields:
        got, want = getattr(params, field), getattr(tmodel.params(), field)
        assert got.dtype == want.dtype or field in ("row_of_slot", "col_of_slot"), field
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    ks = np.linspace(0.55, 2.2, 4)
    fn = tmodel.sweep_fn(KrylovConfig(**dict(CONFIG, restart=30)))
    a, b = fn(params, ks), fn(tmodel.params(), ks)
    assert torch.equal(a[1], b[1])
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# The port's two sweeps agree.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port8():
    tm = mg.box_hierarchy(8, 3)
    tmg = mg.GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu")
    model = room.RoomSweepModel(tm[0], assembler=tmg.assemblers[0], **ROOM)
    return tmg, model, NodeMajorRoomSweep(model, tmg)


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_vmapped_sweep_matches_node_major(port8, cycle):
    tmg, model, nm = port8
    ks = np.linspace(0.55, 2.2, 8)
    kw = dict(KNOBS, mg_coarse_anchors=4, mg_cycle_type=cycle)
    p, its, conv = model.sweep_fn(KrylovConfig(**CONFIG), mg_builder=tmg.builder, **kw)(
        model.params(), ks)
    q, nits, nconv = nm.sweep_fn(KrylovConfig(**CONFIG), gmres_orth="cgs2", **kw)(
        nm.params(), ks)
    assert torch.equal(its, nits) and bool(conv.all()) and bool(nconv.all())
    np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=0,
                               atol=1e-9 * float(q.abs().max()))
