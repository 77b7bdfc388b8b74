"""Port vs reference: the single-vector restarted GMRES
(solvers/krylov.py::gmres) and the Jacobi preconditioner.

Dense complex systems made from a seed with numpy go through the
reference's ``gmres`` and the port's, on the CPU in float64: without and
with Jacobi preconditioning, with an initial guess, through a callable
operator, and with a restart shorter than the solve needs (several
cycles). Iteration counts and converged flags must be equal, x within
1e-10 of max|x|. Each reference solve runs as one jitted function (its
eager loops are several times slower than compiling them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
from mathaudio_tpu.solvers import gmres as jax_gmres
from mathaudio_tpu.solvers import jacobi_preconditioner as jax_jacobi
from mathaudio_tpu_torch.solvers.direct import lu_solve
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, as_matvec, gmres
from mathaudio_tpu_torch.solvers.preconditioners.basic import jacobi_preconditioner

N = 40


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _system(seed, spread):
    """A diagonally weighted complex system: the diagonal spans
    ``spread`` decades, so Jacobi preconditioning changes the iteration."""
    rng = np.random.default_rng(seed)
    a = 0.08 * (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N)))
    a += np.diag(np.logspace(0, spread, N) * np.exp(1j * rng.uniform(-0.5, 0.5, N)))
    b = rng.normal(size=N) + 1j * rng.normal(size=N)
    x0 = rng.normal(size=N) + 1j * rng.normal(size=N)
    return a, b, x0


CASES = {
    # name: (spread, jacobi, x0, callable operator, restart, max_iterations, tolerance)
    "plain": (0.5, False, False, False, 30, 200, 1e-10),
    "jacobi": (2.0, True, False, False, 30, 200, 1e-10),
    "jacobi_x0": (2.0, True, True, False, 30, 200, 1e-10),
    "callable": (0.5, False, False, True, 30, 200, 1e-10),
    "short_restart": (0.5, False, False, False, 4, 200, 1e-10),
    "short_restart_jacobi_x0": (2.0, True, True, False, 3, 200, 1e-9),
    "budget_exhausted": (0.5, False, False, False, 3, 6, 1e-12),
    "no_budget": (0.5, False, True, False, 5, 0, 1e-10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gmres_matches_reference(case):
    spread, use_jacobi, use_x0, use_callable, restart, max_it, tol = CASES[case]
    a, b, x0 = _system(3, spread)
    cfg = dict(max_iterations=max_it, tolerance=tol, restart=restart)

    def reference(ja, jb, jx0):
        return jax_gmres((lambda v: ja @ v) if use_callable else ja, jb,
                         x0=jx0 if use_x0 else None, config=JaxKrylovConfig(**cfg),
                         preconditioner=jax_jacobi(jnp.diagonal(ja)) if use_jacobi else None)

    ref = jax.jit(reference)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x0))
    ta = torch.tensor(a)
    sol = gmres((lambda v: ta @ v) if use_callable else ta, torch.tensor(b),
                x0=torch.tensor(x0) if use_x0 else None, config=KrylovConfig(**cfg),
                preconditioner=jacobi_preconditioner(torch.diagonal(ta)) if use_jacobi else None)
    assert int(sol.iterations) == int(ref.iterations)
    assert bool(sol.converged) == bool(ref.converged)
    rx = np.asarray(ref.x)
    assert np.max(np.abs(sol.x.numpy() - rx)) < 1e-10 * np.max(np.abs(rx))
    np.testing.assert_allclose(float(sol.residual_norm), float(ref.residual_norm),
                               rtol=1e-6, atol=1e-14)
    if case in ("plain", "jacobi", "short_restart"):
        assert bool(sol.converged) and int(sol.iterations) > restart * (case == "short_restart")
        exact = lu_solve(ta, torch.tensor(b))
        assert float(torch.max(torch.abs(sol.x - exact))) < 1e-8


def test_jacobi_preconditioner_matches_reference():
    d = np.array([2.0 + 1j, 0.0, -0.5j, 1e-301, 3.0])
    ref = np.asarray(jax_jacobi(jnp.asarray(d)).matvec(jnp.ones(5, complex)))
    pre = jacobi_preconditioner(torch.tensor(d))
    got = pre.matvec(torch.ones(5, dtype=torch.complex128))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15, atol=0)
    assert torch.equal(pre(torch.ones(5, dtype=torch.complex128)), got)


def test_gmres_takes_operators_and_refuses_misuse():
    a, b, _ = _system(5, 0.5)
    ta, tb = torch.tensor(a), torch.tensor(b)

    class Op:
        def matvec(self, v):
            return ta @ v

    s1 = gmres(Op(), tb, config=KrylovConfig(tolerance=1e-10))
    s2 = gmres(ta, tb, config=KrylovConfig(tolerance=1e-10))
    assert torch.equal(s1.x, s2.x) and int(s1.iterations) == int(s2.iterations)
    assert s1.iterations.dtype == torch.int32 and s1.converged.dtype == torch.bool
    with pytest.raises(TypeError, match="config="):
        gmres(ta, tb, KrylovConfig())
    with pytest.raises(TypeError, match="linear operator"):
        as_matvec(torch.zeros(3))


def test_gmres_float32_runs_in_working_precision():
    a, b, _ = _system(9, 0.5)
    ta, tb = torch.tensor(a, dtype=torch.complex64), torch.tensor(b, dtype=torch.complex64)
    sol = gmres(ta, tb, config=KrylovConfig(tolerance=1e-5, restart=30))
    assert sol.x.dtype == torch.complex64 and sol.residual_norm.dtype == torch.float32
    assert bool(sol.converged)
    res = torch.linalg.vector_norm(ta @ sol.x - tb) / torch.linalg.vector_norm(tb)
    assert float(res) < 1e-4
