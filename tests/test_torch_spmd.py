"""Port vs reference: parallel/spmd.py (the halo and all-gather ELL
matvecs, the device Schwarz apply, the sharded GMRES with and without
Schwarz and with the Ghysels variant, the row-sharded dense solve),
BemSolver's ``device_mesh`` route, and every Krylov solver with
``axis_name``, at 2 ranks here and at 4 in test_torch_spmd_4ranks.py (a
file of its own, so that a parallel test run takes the two at once).

The port runs in gloo ranks spawned once per world size
(``parallel.launch``, rank functions in ``_torch_parallel_ranks.py``),
beside the reference, which is built once per world size and runs its
``shard_map`` over the first 2 or 4 of conftest's 8 virtual CPU devices,
on the same seeded numpy inputs, in float64. Rank r's
rows are held against the reference's shard r: matvecs to 1e-12 of max|y|,
solutions to 1e-9 of max|x| with equal iteration counts. The sizes leave
the last shard with padding rows (50 rows over 4 shards, a 30 x 30 dense
matrix over 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import mathaudio_tpu.solvers.krylov as jax_krylov
from _torch_parallel_ranks import KRYLOV_NAMES, launch_beside, spmd_rank
from mathaudio_tpu.bem import BemProblem, BemSolver, BemSolverConfig
from mathaudio_tpu.bem.types import SolverMethod
from mathaudio_tpu.parallel import spmd as jax_spmd
from mathaudio_tpu.solvers.sparse import CsrMatrix

N = 50
GMRES_CFG = dict(max_iterations=200, tolerance=1e-10, restart=40)
# The Ghysels p(1) variant at a tolerance above its square-root breakdown:
# below ~1e-8 here the breakdown test (h^2 <= 4 eps ||z||^2) is decided by
# rounding, and the reference's own counts then depend on the device count
# (13, 8, 7 and 33 iterations on 1, 2, 4 and 8 devices at 1e-10).
GHYSELS_CFG = dict(max_iterations=200, tolerance=1e-7, restart=40)
DENSE_CFG = dict(max_iterations=100, tolerance=1e-12, restart=40)
AXIS_CFG = dict(max_iterations=200, tolerance=1e-10, restart=10)
BEM_BASE = dict(method=SolverMethod.GMRES, tolerance=1e-9, max_iterations=400, restart=40)


def _helmholtz_1d(n, k=2.0, shift=None):
    """Tridiagonal 1D FD Helmholtz with a small absorption (the
    reference's banded testbed); ``shift`` gives instead the
    well-conditioned (shift, -1) stencil of its Schwarz-free test."""
    h = 1.0 / (n + 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    if shift is None:
        vals = np.concatenate([(2.0 / h**2 - k**2) * np.ones(n), (-1.0 / h**2) * np.ones(n - 1),
                               (-1.0 / h**2) * np.ones(n - 1)]).astype(complex)
        vals[:n] += 1j * 0.3 * k
    else:
        vals = np.concatenate([shift * np.ones(n), -np.ones(2 * n - 2)]).astype(complex)
    return CsrMatrix.from_triplets(rows, cols, vals, (n, n))


def _complex(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _inputs():
    rng = np.random.default_rng(7)
    csr, easy = _helmholtz_1d(N), _helmholtz_1d(N, shift=4.0 + 0.3j)
    xs = np.linspace(0, 1, N)
    a = 0.05 * _complex(rng, 48, 48) + np.diag(np.logspace(0, 1, 48))
    h = _complex(rng, 48, 48)
    dense_a = _complex(rng, 30, 30) + 30 * np.eye(30)
    return dict(
        csr=dict(indptr=csr.indptr, indices=csr.indices, data=csr.data, shape=csr.shape),
        csr_easy=dict(indptr=easy.indptr, indices=easy.indices, data=easy.data,
                      shape=easy.shape),
        x=_complex(rng, N), r=_complex(rng, N), rhs=np.exp(-((xs - 0.4) ** 2) / 0.02) + 0j,
        dense_a=dense_a, dense_rhs=_complex(rng, 30),
        a=a, h=h @ h.conj().T / 48 + np.eye(48), b=_complex(rng, 48), x0=_complex(rng, 48),
        gmres_cfg=GMRES_CFG, ghysels_cfg=GHYSELS_CFG, dense_cfg=DENSE_CFG, axis_cfg=AXIS_CFG)


INPUTS = _inputs()
CSR = _helmholtz_1d(N)
CSR_EASY = _helmholtz_1d(N, shift=4.0 + 0.3j)


def _padded(v, s):
    r = -(-len(v) // s)
    out = np.zeros(r * s, v.dtype)
    out[:len(v)] = v
    return out.reshape(s, r)


def _shard_map(mesh, fn, n_in, n_out):
    out_specs = P("dof") if n_out == 1 else (P("dof"),) * n_out
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("dof"),) * n_in,
                                 out_specs=out_specs, check_vma=False))


def _reference(s):
    """Every reference result at s devices."""
    mesh = Mesh(np.asarray(jax.devices()[:s]), ("dof",))
    out = {}
    ell = jax_spmd.shard_ell(CSR, s)
    out["halo_y"] = np.asarray(_shard_map(mesh, lambda i, v, x: jax_spmd.ell_local_matvec(
        i[0], v[0], x[0], ell.halo, "dof", s)[None], 3, 1)(
        ell.indices, ell.values, jnp.asarray(_padded(INPUTS["x"], s))))
    dsz = jax_spmd.DeviceSchwarz.from_csr(CSR, s, 2)
    out["schwarz_y"] = np.asarray(_shard_map(mesh, lambda g, inv, v, w, r_: jax_spmd.schwarz_apply_local(
        g[0], inv[0], v[0], w[0], r_[0], dsz.overlap, "dof", s)[None], 5, 1)(
        dsz.gather_idx, dsz.inv_blocks, dsz.valid, dsz.weights,
        jnp.asarray(_padded(INPUTS["r"], s))))
    cfg, ghysels_cfg = (jax_krylov.KrylovConfig(**c) for c in (GMRES_CFG, GHYSELS_CFG))
    for label, c, overlap, kcfg, solver in (
            ("schwarz", CSR, 2, cfg, jax_krylov.gmres), ("none", CSR_EASY, None, cfg,
                                                         jax_krylov.gmres),
            ("ghysels", CSR, 2, ghysels_cfg, jax_krylov.gmres_pipelined_ghysels)):
        system = jax_spmd.build_sharded_system(c, INPUTS["rhs"], s, schwarz_overlap=overlap)
        out[("sharded_gmres", label)] = jax.jit(jax_spmd.sharded_gmres_fn(
            mesh, kcfg, solver=solver))(system)
    a_blocks, rhs_sh = jax_spmd.shard_dense_rows(INPUTS["dense_a"], INPUTS["dense_rhs"], s)
    out["dense"] = jax.jit(jax_spmd.sharded_dense_gmres_fn(
        mesh, jax_krylov.KrylovConfig(**DENSE_CFG)))(a_blocks, rhs_sh)

    acfg = jax_krylov.KrylovConfig(**AXIS_CFG)
    for name in KRYLOV_NAMES:
        m = INPUTS["h"] if name == "cg" else INPUTS["a"]
        solver = getattr(jax_krylov, name)

        def local(ab, bb, x0b, solver=solver, name=name):
            args = (lambda x: jax_spmd.dense_rowblock_matvec(ab[0], x, "dof"), bb[0])
            if name == "gmres_with_guess":
                args += (x0b[0],)
            sol = solver(*args, config=acfg, axis_name="dof")
            return sol.x[None], sol.iterations[None], sol.converged[None]

        out[("axis", name)] = _shard_map(mesh, local, 3, 3)(
            jnp.asarray(m.reshape(s, 48 // s, 48)), jnp.asarray(INPUTS["b"].reshape(s, -1)),
            jnp.asarray(INPUTS["x0"].reshape(s, -1)))
    for kind, prob in (("rigid", BemProblem.rigid_sphere(1.5, subdivisions=2)),
                       ("mixed", BemProblem.radiating_sphere(1.0, subdivisions=1))):
        sol = BemSolver(BemSolverConfig(**BEM_BASE, device_mesh=mesh)).solve(prob)
        out[("bem", kind)] = (np.asarray(sol.surface_pressure), sol.info)
    return out


def run(s):
    """(s, every rank's results, the reference's) at s ranks. The ranks took
    15 s (2) and 31 s (4) beside five other test workers; a rank still
    running at ``join_timeout`` (~4x that) fails the test."""
    port, ref = launch_beside(lambda: _reference(s), spmd_rank, s, INPUTS, timeout=25 * s,
                              join_timeout=30 * s)
    return s, port, ref


@pytest.fixture(scope="module", params=[2], ids=["2ranks"])
def runs(request):
    return run(request.param)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("key", ["halo_y", "schwarz_y"])
def test_matvec_rank_by_rank(runs, key):
    s, port, ref = runs
    for rank in range(s):
        _close(port[rank][key], ref[key][rank], 1e-12)


def test_allgather_matvec_is_the_halo_matvec(runs):
    s, port, _ = runs
    y = np.concatenate([port[rank]["allgather_y"].numpy() for rank in range(s)])[:N]
    _close(y, CSR.matvec(INPUTS["x"]), 1e-12)


@pytest.mark.parametrize("label", ["schwarz", "none", "ghysels"])
def test_sharded_gmres(runs, label):
    s, port, ref = runs
    want = ref[("sharded_gmres", label)]
    assert bool(want.converged)
    for rank in range(s):
        got = port[rank][("sharded_gmres", label)]
        assert got["converged"] and got["iterations"] == int(want.iterations)
        assert got["x"].shape == tuple(want.x.shape)  # (S, R) on every rank
        _close(got["x"], want.x, 1e-9)
    if label == "schwarz":
        _close(jax_spmd.unshard(want.x, N), np.linalg.solve(CSR.to_dense(), INPUTS["rhs"]), 1e-7)


def test_dense_rowblock_solve(runs):
    s, port, ref = runs
    want = ref["dense"]
    assert bool(want.converged)
    for rank in range(s):
        got = port[rank]["dense"]
        assert got["converged"] and got["iterations"] == int(want.iterations)
        _close(got["x"], want.x, 1e-9)


@pytest.mark.parametrize("name", KRYLOV_NAMES)
def test_solver_with_axis_name(runs, name):
    s, port, ref = runs
    x, its, conv = (np.asarray(a) for a in ref[("axis", name)])
    for rank in range(s):
        for how in ("name", "group"):
            got = port[rank]["axis"][(name, how)]
            assert got["iterations"] == int(its[rank]) and got["converged"] == bool(conv[rank])
            _close(got["x"], x[rank], 1e-9)


@pytest.mark.parametrize("kind", ["rigid", "mixed"])
def test_bem_solver_device_mesh(runs, kind):
    """A rigid problem's solve runs row-sharded over every rank (each rank
    assembling its own rows); a mixed one runs unsharded, as the
    reference's does."""
    s, port, ref = runs
    p_ref, info_ref = ref[("bem", kind)]
    for rank in range(s):
        got = port[rank][("bem", kind)]
        _close(got["p"], p_ref, 1e-9)
        assert got["info"]["converged"] == info_ref["converged"]
        assert got["info"]["iterations"] == info_ref["iterations"]
        assert got["info"].get("sharded_over") == info_ref.get("sharded_over")
    assert (info_ref.get("sharded_over") == s) == (kind == "rigid")
