"""Port vs reference: the Krylov family (solvers/krylov.py: cg, bicgstab,
cgs, qmrcgstab, gmres_pipelined_ghysels and the gmres aliases), the
reusable LU factors (solvers/direct.py::LuFactorization) and the vector
helpers (solvers/blas.py).

Systems made from a seed with numpy go through both packages on the CPU in
float64: a complex non-symmetric one (diagonally weighted, so Jacobi
preconditioning changes the iteration) for every solver, a Hermitian
positive-definite one for cg, each with and without Jacobi, with an initial
guess, and with a budget too small to converge. Iteration counts and the
converged flags are equal; x agrees within 1e-10 of max|x|. Each reference
solve is jitted (its eager loops are slower than compiling them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.solvers.blas as jax_blas
from _torch_parallel_ranks import one_rank_group
import mathaudio_tpu.solvers.krylov as jax_krylov
from mathaudio_tpu.solvers import jacobi_preconditioner as jax_jacobi
from mathaudio_tpu.solvers.direct import LuFactorization as JaxLu
from mathaudio_tpu_torch.solvers import blas, krylov
from mathaudio_tpu_torch.solvers.direct import LuFactorization
from mathaudio_tpu_torch.solvers.preconditioners.basic import jacobi_preconditioner

N = 40
SOLVERS = ["cg", "bicgstab", "cgs", "qmrcgstab", "gmres_pipelined_ghysels", "gmres",
           "gmres_pipelined"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _complex(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _systems():
    """(general, hpd, b, x0): the general matrix's diagonal spans a decade
    with a dominant margin (the stabilised recurrences' iteration counts
    stay away from rounding), the HPD one is B B^H + N I."""
    rng = np.random.default_rng(5)
    a = 0.05 * _complex(rng, N, N)
    a += np.diag(np.logspace(0, 1, N) * np.exp(1j * rng.uniform(-0.4, 0.4, N)))
    h = _complex(rng, N, N)
    h = h @ h.conj().T / N + np.eye(N)
    return a, h, _complex(rng, N), _complex(rng, N)


A, H, B, X0 = _systems()
# Tolerance 1e-8: below ~1e-9 unpreconditioned CGS's residual (the square
# of BiCG's polynomial) amplifies rounding, and the two packages' summation
# orders part there (on this system their residuals differ from step 23 on,
# at the 1e-9 level; to 1e-10 the port takes 27 steps, the reference 26).
CASES = {
    # name: (jacobi, x0, max_iterations, tolerance, restart)
    "plain": (False, False, 200, 1e-8, 8),
    "jacobi": (True, False, 200, 1e-8, 8),
    "jacobi_x0": (True, True, 200, 1e-8, 8),
    "budget": (False, True, 3, 1e-12, 8),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", SOLVERS)
def test_solver_matches_reference(name, case):
    use_jacobi, use_x0, max_it, tol, restart = CASES[case]
    a = H if name == "cg" else A
    cfg = dict(max_iterations=max_it, tolerance=tol, restart=restart)

    def reference(ja, jb, jx0):
        return getattr(jax_krylov, name)(
            ja, jb, x0=jx0 if use_x0 else None, config=jax_krylov.KrylovConfig(**cfg),
            preconditioner=jax_jacobi(jnp.diagonal(ja)) if use_jacobi else None)

    ref = jax.jit(reference)(jnp.asarray(a), jnp.asarray(B), jnp.asarray(X0))
    ta = torch.tensor(a)
    sol = getattr(krylov, name)(
        ta, torch.tensor(B), x0=torch.tensor(X0) if use_x0 else None,
        config=krylov.KrylovConfig(**cfg),
        preconditioner=jacobi_preconditioner(torch.diagonal(ta)) if use_jacobi else None)
    assert int(sol.iterations) == int(ref.iterations)
    assert bool(sol.converged) == bool(ref.converged) == (case != "budget")
    rx = np.asarray(ref.x)
    assert np.max(np.abs(sol.x.numpy() - rx)) < 1e-10 * np.max(np.abs(rx))
    # the relative residual, near the tolerance: its last digits are rounding
    assert abs(float(sol.residual_norm) - float(ref.residual_norm)) <= 1e-2 * tol + 1e-6 * float(
        ref.residual_norm)


def test_cg_on_a_real_spd_system_matches_reference():
    h = H.real + 0.5 * N * np.eye(N)
    h = (h + h.T) / 2
    b = B.real
    cfg = dict(max_iterations=200, tolerance=1e-11)
    ref = jax.jit(lambda m, v: jax_krylov.cg(m, v, config=jax_krylov.KrylovConfig(**cfg)))(
        jnp.asarray(h), jnp.asarray(b))
    sol = krylov.cg(torch.tensor(h), torch.tensor(b), config=krylov.KrylovConfig(**cfg))
    assert sol.x.dtype == torch.float64
    assert int(sol.iterations) == int(ref.iterations) and bool(sol.converged)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)


def test_ghysels_restarts_through_its_breakdown_like_the_reference():
    """A restart longer than the problem needs drives the Pythagorean norm
    to its square-root breakdown; both restart from the true residual."""
    rng = np.random.default_rng(9)
    a = np.diag(np.linspace(1.0, 2.0, 12)) + 1e-3 * _complex(rng, 12, 12)
    b = _complex(rng, 12)
    cfg = dict(max_iterations=60, tolerance=1e-13, restart=12)
    ref = jax.jit(lambda m, v: jax_krylov.gmres_pipelined_ghysels(
        m, v, config=jax_krylov.KrylovConfig(**cfg)))(jnp.asarray(a), jnp.asarray(b))
    sol = krylov.gmres_pipelined_ghysels(torch.tensor(a), torch.tensor(b),
                                         config=krylov.KrylovConfig(**cfg))
    assert int(sol.iterations) == int(ref.iterations)
    assert bool(sol.converged) == bool(ref.converged)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)


def test_gmres_aliases_are_gmres():
    ta, tb, tx0 = torch.tensor(A), torch.tensor(B), torch.tensor(X0)
    cfg = krylov.KrylovConfig(max_iterations=100, tolerance=1e-10, restart=10)
    base = krylov.gmres(ta, tb, x0=tx0, config=cfg)
    for sol in (krylov.gmres_with_guess(ta, tb, tx0, config=cfg),
                krylov.gmres_pipelined(ta, tb, x0=tx0, config=cfg)):
        assert torch.equal(sol.x, base.x) and int(sol.iterations) == int(base.iterations)


@pytest.mark.parametrize("name", SOLVERS + ["gmres_with_guess"])
def test_axis_name_on_a_one_rank_group_gets_the_unsharded_answer(name):
    """``axis_name`` (the mesh axis, then the process group itself) on a
    one-rank gloo group: every reduction is all-reduced over one rank, and
    the solve takes the unsharded iterations to the unsharded x
    (tests/test_torch_spmd.py holds 2 and 4 ranks against the reference)."""
    from mathaudio_tpu_torch.parallel.mesh import use_mesh

    ta, tb = torch.tensor(H if name == "cg" else A), torch.tensor(B)
    args = (ta, tb, torch.tensor(X0)) if name == "gmres_with_guess" else (ta, tb)
    cfg = krylov.KrylovConfig(max_iterations=200, tolerance=1e-10, restart=10)
    want = getattr(krylov, name)(*args, config=cfg)
    with one_rank_group() as mesh, use_mesh(mesh):
        for axis in ("dof", mesh.get_group("dof")):
            got = getattr(krylov, name)(*args, config=cfg, axis_name=axis)
            assert int(got.iterations) == int(want.iterations)
            assert bool(got.converged) and bool(want.converged)
            np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="no device mesh is in use"):
        getattr(krylov, name)(*args, config=cfg, axis_name="dof")


@pytest.mark.parametrize("method", ["auto", "native", "embed"])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_lu_factorization_matches_reference(method, rhs):
    rng = np.random.default_rng(2)
    b = _complex(rng, N) if rhs == "vector" else _complex(rng, N, 3)
    ref = JaxLu.factor(jnp.asarray(A), method=method).solve(jnp.asarray(b))
    lu = LuFactorization.factor(torch.tensor(A), method=method)
    assert lu.embedded is False and lu.n == N and lu.lu.shape == (N, N)
    x = lu.solve(torch.tensor(b))
    assert x.shape == b.shape
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), rtol=0, atol=1e-11)
    np.testing.assert_allclose(A @ x.numpy(), b, rtol=0, atol=1e-10)


def test_blas_matches_reference():
    rng = np.random.default_rng(4)
    x, y = _complex(rng, 17), _complex(rng, 17)
    alpha, beta = 0.3 - 1.2j, -0.7 + 0.1j
    tx, ty = torch.tensor(x), torch.tensor(y)
    for got, want in (
        (blas.inner_product(tx, ty), jax_blas.inner_product(x, y)),
        (blas.vector_norm(tx), jax_blas.vector_norm(x)),
        (blas.axpy(alpha, tx, ty), jax_blas.axpy(alpha, x, y)),
        (blas.axpby(alpha, tx, beta, ty), jax_blas.axpby(alpha, x, beta, y)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14, atol=1e-14)
    assert torch.isclose(blas.inner_product(tx, ty), torch.conj(blas.inner_product(ty, tx)))
    assert not blas.vector_norm(tx).is_complex()


@pytest.mark.parametrize("x0", [False, True])
def test_gmres_batched_vmapped_follows_gmres_lane_for_lane(x0):
    """gmres_batched(vmapped=True) is gmres on each lane: three systems that
    converge in one cycle, after restarts, and not within the budget."""
    from mathaudio_tpu_torch.solvers.krylov_batched import gmres_batched

    rng = np.random.default_rng(11)
    n, noise = 30, (0.002, 0.05, 0.3)  # off-diagonal weight per lane
    mats = np.stack([e * _complex(rng, n, n) + np.diag(np.logspace(0, 2, n)) for e in noise])
    b = _complex(rng, n, len(noise))
    guess = _complex(rng, n, len(noise)) if x0 else None
    cfg = krylov.KrylovConfig(max_iterations=24, tolerance=1e-11, restart=8)
    ta = torch.tensor(mats)
    inv_diag = 1.0 / torch.diagonal(ta, dim1=1, dim2=2).T  # (N, F)
    sol = gmres_batched(lambda v: torch.einsum("fij,jf->if", ta, v), torch.tensor(b), config=cfg,
                        preconditioner=lambda v: inv_diag * v,
                        x0=None if guess is None else torch.tensor(guess), vmapped=True)
    its = []
    for f in range(len(noise)):
        one = krylov.gmres(ta[f], torch.tensor(b[:, f]),
                           x0=None if guess is None else torch.tensor(guess[:, f]), config=cfg,
                           preconditioner=jacobi_preconditioner(torch.diagonal(ta[f])))
        its.append(int(one.iterations))
        assert int(sol.iterations[f]) == int(one.iterations)
        assert bool(sol.converged[f]) == bool(one.converged)
        np.testing.assert_allclose(sol.x[:, f].numpy(), one.x.numpy(), rtol=0, atol=1e-12)
    assert its[0] < 8 < its[1] and not bool(sol.converged[2])
