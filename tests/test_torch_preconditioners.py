"""Port vs reference: the preconditioners of slice 6b (the colored ILU(0)
and its greedy coloring, additive Schwarz and block Jacobi, AMG with its
PMIS coarsening) and their native C++ set-up kernels.

The matrices are the Helmholtz systems of a small annulus (2D, Robin outer
boundary) and a spherical shell (3D), assembled by the port in float64 on
the CPU; both packages get the same numpy CSR. The PMIS C/F splits and the
colorings are equal as integers (the port's C++ kernels also equal their
Python twins); every apply agrees within 1e-10 of max|y|, from the port's
own set-up and from the reference's set-up carried across by
``mathaudio_tpu_torch.convert``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mathaudio_tpu.solvers.preconditioners.amg as jax_amg
import mathaudio_tpu.solvers.preconditioners.ilu as jax_ilu
import mathaudio_tpu.solvers.preconditioners.schwarz as jax_schwarz
from mathaudio_tpu.solvers.sparse import CsrMatrix as JaxCsr
from mathaudio_tpu_torch import convert
from mathaudio_tpu_torch.fem import HelmholtzProblem, RobinBC
from mathaudio_tpu_torch.fem.mesh import annular_mesh_triangles, spherical_shell_mesh_tetrahedra
from mathaudio_tpu_torch.solvers.preconditioners import amg, ilu, schwarz
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix

CPU64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _system(kind):
    """Host CSR arrays (indptr, indices, complex values, shape) of a small
    Helmholtz system."""
    if kind == "annulus":
        mesh, k, r_out, dim = annular_mesh_triangles(1.0, 3.0, 7, 28), 1.5, 3.0, 2
    else:
        mesh, k, r_out, dim = spherical_shell_mesh_tetrahedra(1.0, 2.5, 3, 1), 1.0, 2.5, 3
    prob = HelmholtzProblem(mesh, k, robin=[RobinBC.absorbing_curved(2, k, r_out, dim=dim)],
                            **CPU64)
    csr = prob._csr()
    return csr.indptr, csr.indices, csr.data, csr.shape


SYSTEMS = {kind: _system(kind) for kind in ("annulus", "shell")}


def _csrs(kind):
    indptr, indices, data, shape = SYSTEMS[kind]
    return JaxCsr(indptr, indices, data, shape), CsrMatrix(indptr, indices, data, shape)


def _scipy(kind):
    indptr, indices, data, shape = SYSTEMS[kind]
    return sp.csr_matrix((data, indices, indptr), shape=shape)


def _residual(kind, seed=0):
    n = SYSTEMS[kind][3][0]
    rng = np.random.default_rng(seed)
    return rng.normal(size=n) + 1j * rng.normal(size=n)


def _close(got, want, tol=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


# --------------------------------------------------------------------------
# The set-up kernels: equal as integers.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [0.25, 0.5])
@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_pmis_split_equals_reference(kind, theta):
    a = _scipy(kind)
    s_ref = jax_amg._strength_graph(a, theta)
    s = amg._strength_graph(a, theta)
    assert (s_ref != s).nnz == 0
    want = jax_amg._pmis(s_ref)
    assert want.dtype == bool and 0 < want.sum() < len(want)
    for seed, got in ((0, amg._pmis(s)), (0, amg._pmis_python(s))):
        np.testing.assert_array_equal(got.astype(np.int8), want.astype(np.int8))
    np.testing.assert_array_equal(amg._pmis(s, seed=3), jax_amg._pmis(s_ref, seed=3))


@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_greedy_coloring_equals_reference(kind):
    jc, tc = _csrs(kind)
    want = jax_ilu.greedy_coloring(jc)
    got = ilu.greedy_coloring(tc)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ilu._greedy_coloring_python(tc), want)
    # a proper coloring of the symmetrized graph
    a = _scipy(kind)
    rows, cols = (a + a.T).nonzero()
    off = rows != cols
    assert np.all(got[rows[off]] != got[cols[off]])


def test_native_graph_arguments_are_checked():
    from mathaudio_tpu_torch import native

    with pytest.raises(ValueError, match="outside"):
        native.greedy_coloring(np.array([0, 1]), np.array([3]))
    with pytest.raises(ValueError, match="weights"):
        native.pmis_coarsen(np.array([0, 1, 2]), np.array([1, 0]), np.ones(3))


# --------------------------------------------------------------------------
# AMG: strength, interpolation, hierarchy, apply and solve.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_direct_interpolation_equals_reference(kind):
    a = _scipy(kind)
    s = amg._strength_graph(a, 0.25)
    c = amg._pmis(s)
    want = jax_amg._direct_interpolation(a, s, c, 4)
    got = amg._direct_interpolation(a, s, c, 4)
    assert got.shape == want.shape and abs(got - want).max() < 1e-14


def test_amg_config_presets_equal_reference():
    for preset in ("for_fem", "for_bem", "for_parallel", "for_difficult_problems"):
        assert vars(getattr(amg.AmgConfig, preset)()) == vars(getattr(jax_amg.AmgConfig, preset)())
    assert vars(amg.AmgConfig()) == vars(jax_amg.AmgConfig())


@pytest.fixture(scope="module", params=list(SYSTEMS))
def amg_pair(request):
    kind = request.param
    a = _scipy(kind)
    cfg = jax_amg.AmgConfig.for_difficult_problems() if kind == "annulus" else None
    ref = jax_amg.AmgPreconditioner(a, cfg)
    port = amg.AmgPreconditioner(a, None if cfg is None else amg.AmgConfig(**vars(cfg)), **CPU64)
    return kind, ref, port


def test_amg_hierarchy_equals_reference(amg_pair):
    _, ref, port = amg_pair
    assert port.level_sizes == ref.level_sizes and len(port.level_sizes) >= 3
    assert port.grid_complexity == ref.grid_complexity
    assert port.operator_complexity == ref.operator_complexity
    for lp, lr in zip(port.mgp.levels, ref.mgp.levels):
        for f in lr._fields:
            np.testing.assert_array_equal(getattr(lp, f).numpy(), np.asarray(getattr(lr, f)))
    # the coarsest real-embedded inverse, both taken of the same matrix
    _close(port.mgp.coarse_inv, ref.mgp.coarse_inv)


def test_amg_apply_matches_reference(amg_pair):
    kind, ref, port = amg_pair
    r = _residual(kind)
    want = np.asarray(ref.matvec(jnp.asarray(r)))
    _close(port.matvec(torch.tensor(r)), want)
    tree = types.SimpleNamespace(
        config=ref.config,
        mgp=types.SimpleNamespace(
            levels=[types.SimpleNamespace(**{f: np.asarray(getattr(lvl, f)) for f in lvl._fields})
                    for lvl in ref.mgp.levels],
            coarse_inv=np.asarray(ref.mgp.coarse_inv)))
    carried = convert.amg_preconditioner_from_numpy(tree, **CPU64)
    _close(carried.matvec(torch.tensor(r)), want)
    # a real right-hand side gives a real result, as in the reference
    got_real = port.matvec(torch.tensor(r.real))
    assert not got_real.is_complex()
    _close(got_real, np.asarray(ref.matvec(jnp.asarray(r.real))))


def test_amg_solve_matches_reference(amg_pair):
    kind, ref, port = amg_pair
    r = _residual(kind, 1)
    x_ref, cycles_ref = ref.solve(jnp.asarray(r), tol=1e-6, max_cycles=8)
    x, cycles = port.solve(torch.tensor(r), tol=1e-6, max_cycles=8)
    assert int(cycles) == int(cycles_ref)
    _close(x, x_ref)


# --------------------------------------------------------------------------
# Additive Schwarz and block Jacobi.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [0, 1, 2])
def test_schwarz_partition_and_blocks_equal_reference(overlap):
    jc, tc = _csrs("annulus")
    part = list(range(20, 50))
    want = jax_schwarz._extend_partition(part, jc.indptr, jc.indices, overlap, jc.shape[0])
    assert schwarz._extend_partition(part, tc.indptr, tc.indices, overlap, tc.shape[0]) == want
    parts = [want, list(range(60, 75))]
    np.testing.assert_array_equal(schwarz.csr_diag_blocks(tc, parts, len(want) + 2),
                                  jax_schwarz.csr_diag_blocks(jc, parts, len(want) + 2))


@pytest.mark.parametrize("cls,args", [("AdditiveSchwarz", (4, 1)), ("AdditiveSchwarz", (3, 2)),
                                      ("BlockJacobi", (5,))])
@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_schwarz_apply_matches_reference(kind, cls, args):
    jc, tc = _csrs(kind)
    ref = getattr(jax_schwarz, cls).from_csr(jc, *args)
    port = getattr(schwarz, cls).from_csr(tc, *args, device="cpu")
    assert tuple(port.inv_blocks.shape) == tuple(ref.inv_blocks.shape)
    np.testing.assert_array_equal(port.gather_idx.numpy(), np.asarray(ref.gather_idx))
    np.testing.assert_array_equal(port.weights.numpy(), np.asarray(ref.weights))
    r = _residual(kind)
    want = np.asarray(ref.matvec(jnp.asarray(r)))
    _close(port.matvec(torch.tensor(r)), want)
    carried = convert.additive_schwarz_from_numpy(
        types.SimpleNamespace(**{f: np.asarray(getattr(ref, f))
                                 for f in ("gather_idx", "inv_blocks", "weights", "valid_mask")}),
        **CPU64)
    _close(carried.matvec(torch.tensor(r)), want)


# --------------------------------------------------------------------------
# The colored ILU(0).
# --------------------------------------------------------------------------


def _ell(op):
    return types.SimpleNamespace(indices=np.asarray(op.indices), values=np.asarray(op.values),
                                 num_cols=op.num_cols)


@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_ilu_colored_apply_matches_reference(kind):
    jc, tc = _csrs(kind)
    ref = jax_ilu.IluColored.from_csr(jc)
    port = ilu.IluColored.from_csr(tc, device="cpu")
    assert port.n_colors == ref.n_colors >= 2
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    r = _residual(kind)
    want = np.asarray(ref.matvec(jnp.asarray(r)))
    _close(port.matvec(torch.tensor(r)), want)
    carried = convert.ilu_colored_from_numpy(types.SimpleNamespace(
        perm=np.asarray(ref.perm), inv_perm=np.asarray(ref.inv_perm),
        inner=types.SimpleNamespace(l_op=_ell(ref.inner.l_op), u_strict_op=_ell(ref.inner.u_strict_op),
                                    u_diag_inv=np.asarray(ref.inner.u_diag_inv),
                                    sweeps=ref.inner.sweeps)), **CPU64)
    _close(carried.matvec(torch.tensor(r)), want)


def test_ilu_colored_sweeps_solve_the_factors_exactly():
    """n_colors sweeps solve the permuted triangular factors exactly: the
    apply equals the permuted dense L U solve."""
    _, tc = _csrs("annulus")
    pre = ilu.IluColored.from_csr(tc, device="cpu")
    perm = pre.perm.numpy()
    a = sp.csr_matrix((tc.data, tc.indices, tc.indptr), shape=tc.shape)[perm][:, perm].tocsr()
    a.sort_indices()
    l_csr, u_csr = ilu.ilu0_factor(CsrMatrix(a.indptr, a.indices, a.data, a.shape))
    lower = l_csr.to_dense() + np.eye(a.shape[0])
    r = _residual("annulus", 2)
    x = np.linalg.solve(u_csr.to_dense(), np.linalg.solve(lower, r[perm]))
    want = np.empty_like(x)
    want[perm] = x
    _close(pre.matvec(torch.tensor(r)), want, tol=1e-12)
