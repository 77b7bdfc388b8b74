"""Port vs reference: node-major batched GMRES (solvers/krylov_batched.py).

Per-lane dense systems are solved by the reference's ``gmres_batched``
and the port's; iteration counts and converged flags must be equal lane
for lane, solutions and residuals equal to float64 roundoff. The case of
lanes that restart and spend their budget runs in
test_torch_krylov_batched_restarts.py (a file of its own, so that a
parallel test run takes the two at once: each eager reference compiles
its primitives for its shapes, 10-40 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
from mathaudio_tpu.solvers.krylov import _givens as jax_givens
from mathaudio_tpu.solvers.krylov_batched import gmres_batched as jax_gmres_batched
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, _givens
from mathaudio_tpu_torch.solvers.krylov_batched import gmres_batched


def _well_posed(seed, n=50, nf=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(nf, n, n)) + 1j * rng.normal(size=(nf, n, n))
    a += (25 + 5 * np.arange(nf))[:, None, None] * np.eye(n)
    b = rng.normal(size=(nf, n)) + 1j * rng.normal(size=(nf, n))
    return a, b


def _restart_and_budget():
    # lanes that need > 1 restart cycle, plus a lane that exhausts its budget
    rng = np.random.default_rng(2)
    n, nf = 40, 3
    a = rng.normal(size=(nf, n, n)) + (4 + 12 * np.arange(nf))[:, None, None] * np.eye(n)
    b = rng.normal(size=(nf, n)) + 0j
    return a + 0j, b


CASES = {
    "cgs2": (lambda: _well_posed(1), dict(max_iterations=80, tolerance=1e-9, restart=10),
             dict(orth="cgs2"), True),
    "cgs1": (lambda: _well_posed(1), dict(max_iterations=80, tolerance=1e-9, restart=10),
             dict(orth="cgs1"), True),
    "x0": (lambda: _well_posed(6), dict(max_iterations=80, tolerance=1e-9, restart=6),
           dict(orth="cgs1", x0=True), True),
    "restart_and_budget": (_restart_and_budget,
                           dict(max_iterations=25, tolerance=1e-10, restart=8),
                           dict(orth="cgs2"), False),
    "no_iterations": (lambda: _well_posed(3), dict(max_iterations=0, tolerance=1e-9, restart=4),
                      dict(orth="cgs2"), True),
}


# the cases that test_torch_krylov_batched_restarts.py runs
RESTARTS = ["restart_and_budget"]


@pytest.fixture(params=[c for c in sorted(CASES) if c not in RESTARTS])
def case(request):
    return request.param


def test_matches_reference_lane_for_lane(case):
    make, cfg, kw, precondition = CASES[case]
    a, b = make()
    nf, n, _ = a.shape
    at = np.ascontiguousarray(np.transpose(a, (1, 2, 0)))  # (N, N, F)
    inv_d = 1.0 / np.stack([np.diagonal(a[f]) for f in range(nf)]).T  # (N, F)
    x0 = None
    if kw.get("x0"):
        x0 = np.random.default_rng(7).normal(size=(n, nf)) * 0.1 + 0j

    jat, jinv = jnp.asarray(at), jnp.asarray(inv_d)
    with jax.disable_jit():  # eager: the reference's ops without its compile time
        ref = jax_gmres_batched(
            lambda x: jnp.einsum("nmf,mf->nf", jat, x), jnp.asarray(b.T),
            config=JaxKrylovConfig(**cfg),
            preconditioner=(lambda v: v * jinv) if precondition else None,
            orth=kw["orth"], x0=None if x0 is None else jnp.asarray(x0),
        )
    tat, tinv = torch.tensor(at), torch.tensor(inv_d)
    got = gmres_batched(
        lambda x: torch.einsum("nmf,mf->nf", tat, x), torch.tensor(b.T).contiguous(),
        config=KrylovConfig(**cfg),
        preconditioner=(lambda v: v * tinv) if precondition else None,
        orth=kw["orth"], x0=None if x0 is None else torch.tensor(x0),
    )
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.residual_norm.numpy(), np.asarray(ref.residual_norm),
                               rtol=1e-6, atol=1e-14)
    if case == "restart_and_budget":
        its = got.iterations.numpy()
        assert its.max() >= cfg["max_iterations"] and not got.converged.numpy().all()
        assert its.min() > cfg["restart"]  # every lane needed a restart


def test_fused_residual_is_used_for_restarts():
    a, b = _restart_and_budget()
    at = torch.tensor(np.transpose(a, (1, 2, 0)))
    calls = []

    def a_res(rhs, x):
        calls.append(1)
        return rhs - torch.einsum("nmf,mf->nf", at, x)

    cfg = KrylovConfig(max_iterations=25, tolerance=1e-10, restart=8)
    mv = lambda x: torch.einsum("nmf,mf->nf", at, x)  # noqa: E731
    fused = gmres_batched(mv, torch.tensor(b.T).contiguous(), config=cfg, a_res=a_res)
    plain = gmres_batched(mv, torch.tensor(b.T).contiguous(), config=cfg)
    assert len(calls) >= 2  # one per restart after the first cycle
    assert torch.equal(fused.iterations, plain.iterations)
    assert torch.equal(fused.x, plain.x)


def _staggered(n=48, nf=5, seed=4):
    # one off-diagonal scale a lane: at restart 6 the lanes converge at
    # steps 7, 15 and 24, in the 2nd, 3rd and 4th cycle; two spend the budget
    rng = np.random.default_rng(seed)
    scale = np.array([0.02, 0.15, 0.3, 0.45, 0.6])[:, None, None]
    a = np.eye(n) + scale * (rng.normal(size=(nf, n, n))
                             + 1j * rng.normal(size=(nf, n, n))) / np.sqrt(n)
    b = rng.normal(size=(n, nf)) + 1j * rng.normal(size=(n, nf))
    return torch.tensor(a), torch.tensor(b)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("orth", ["cgs1", "cgs2"])
def test_lane_operator_skips_done_lanes_and_changes_no_lane(orth, warm):
    a, b = _staggered()
    lanes_calls = []

    def a_mv_lanes(v, lanes):
        lanes_calls.append(list(lanes))
        out = torch.zeros_like(v)
        for f in lanes:
            out[:, f] = a[f] @ v[:, f]
        return out

    inv_d = 1.0 / torch.diagonal(a, dim1=-2, dim2=-1).T
    kw = dict(config=KrylovConfig(max_iterations=40, tolerance=1e-10, restart=6),
              preconditioner=lambda v: v * inv_d, orth=orth,
              x0=0.1 * torch.ones_like(b) if warm else None)
    plain = gmres_batched(lambda v: torch.einsum("fij,jf->if", a, v), b, **kw)
    lanes = gmres_batched(lambda v: torch.einsum("fij,jf->if", a, v), b, a_mv_lanes=a_mv_lanes,
                          **kw)
    assert torch.equal(lanes.iterations, plain.iterations)
    assert torch.equal(lanes.converged, plain.converged)
    np.testing.assert_allclose(lanes.x.numpy(), plain.x.numpy(),
                               rtol=0, atol=1e-6 * float(plain.x.abs().max()))
    # the per-lane products round unlike the batched einsum, so a residual
    # near 1e-11 keeps few digits: the reference test's atol
    np.testing.assert_allclose(lanes.residual_norm.numpy(), plain.residual_norm.numpy(),
                               rtol=1e-6, atol=1e-14)
    its = plain.iterations.tolist()
    assert len(set(its)) >= 4 and 6 < min(its) and not all(plain.converged.tolist())
    # a lane is applied at exactly the steps it iterates: never once done
    assert [sum(f in c for c in lanes_calls) for f in range(b.shape[1])] == its
    assert len(lanes_calls) < max(its) * b.shape[1]


def test_givens_matches_reference():
    rng = np.random.default_rng(9)
    a = rng.normal(size=16) + 1j * rng.normal(size=16)
    b = rng.normal(size=16) + 1j * rng.normal(size=16)
    a[:3] = 0.0
    b[2:5] = 0.0
    for got, ref in zip(_givens(torch.tensor(a), torch.tensor(b)),
                        jax_givens(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-15, atol=1e-15)


def test_unknown_orth_rejected():
    with pytest.raises(ValueError, match="orthogonalization"):
        gmres_batched(lambda x: x, torch.ones((4, 2), dtype=torch.complex128), orth="mgs")
