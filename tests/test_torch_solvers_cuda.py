"""On the card: slices 6b and 6c against the CPU, in float64.

The Krylov family, the preconditioner applies (AMG, additive Schwarz, the
fixed-point and the colored ILU), solve_helmholtz under several names, the
FEM room simulator and BemSolver's BiCGStab route (through the Burton–Miller
kernel) run on the GPU and on the CPU from the same inputs: iteration
counts are equal and the answers agree within 1e-9. These tests need a CUDA
device and skip without one; they import no JAX (the CPU parity with the
reference is in the other tests/test_torch_*.py files).

    python -m pytest tests/test_torch_solvers_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from mathaudio_tpu_torch.common.config import RoomConfig
from mathaudio_tpu_torch.fem import HelmholtzProblem, RobinBC, NeumannBC, solve_helmholtz
from mathaudio_tpu_torch.fem.mesh import annular_mesh_triangles
from mathaudio_tpu_torch.solvers import KrylovConfig, krylov
from mathaudio_tpu_torch.solvers.preconditioners import (
    AdditiveSchwarz,
    AmgConfig,
    AmgPreconditioner,
    IluColored,
    IluFixedPoint,
    jacobi_preconditioner,
)

pytestmark = pytest.mark.cuda
F64 = torch.float64


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs slices 6b and 6c on the card)")
    return torch.device("cuda", 0)


def _close(got, want, tol=1e-9):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _annulus(device):
    k = 1.0

    def flux(x):
        n_hat = -x / torch.linalg.norm(x, dim=-1, keepdim=True)
        return -(1j * k * n_hat[..., 0]) * torch.exp(1j * k * x[..., 0])

    return HelmholtzProblem(annular_mesh_triangles(1.0, 3.0, 8, 32), k,
                            neumann=[NeumannBC(1, flux)],
                            robin=[RobinBC.absorbing_curved(2, k, 3.0, dim=2)], dtype=F64,
                            device=device)


@pytest.mark.parametrize("name", ["cg", "bicgstab", "cgs", "qmrcgstab", "gmres",
                                  "gmres_pipelined_ghysels"])
def test_krylov_on_card_matches_cpu(card, name):
    rng = np.random.default_rng(3)
    n = 64
    a = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    a += np.diag(np.logspace(0, 1, n))
    if name == "cg":
        a = a @ a.conj().T
    b = rng.normal(size=n) + 1j * rng.normal(size=n)
    cfg = KrylovConfig(max_iterations=300, tolerance=1e-8, restart=10)
    out = {}
    for dev in (card, torch.device("cpu")):
        ta = torch.tensor(a, device=dev)
        out[dev.type] = getattr(krylov, name)(
            ta, torch.tensor(b, device=dev), config=cfg,
            preconditioner=jacobi_preconditioner(torch.diagonal(ta)))
    assert int(out["cuda"].iterations) == int(out["cpu"].iterations)
    assert bool(out["cuda"].converged) and bool(out["cpu"].converged)
    _close(out["cuda"].x, out["cpu"].x)


@pytest.mark.parametrize("kind", ["amg", "schwarz", "ilu", "ilu_colored"])
def test_preconditioner_apply_on_card_matches_cpu(card, kind):
    csr = _annulus("cpu")._csr()
    build = {
        "amg": lambda dev: AmgPreconditioner(csr, AmgConfig.for_fem(), dtype=F64, device=dev),
        "schwarz": lambda dev: AdditiveSchwarz.from_csr(csr, 4, 1, device=dev),
        "ilu": lambda dev: IluFixedPoint.from_csr(csr, device=dev),
        "ilu_colored": lambda dev: IluColored.from_csr(csr, device=dev),
    }[kind]
    rng = np.random.default_rng(0)
    r = rng.normal(size=csr.shape[0]) + 1j * rng.normal(size=csr.shape[0])
    got = build(card).matvec(torch.tensor(r, device=card))
    assert got.device.type == "cuda"
    _close(got, build("cpu").matvec(torch.tensor(r)), 1e-10)


@pytest.mark.parametrize("name", ["direct", "gmres_jacobi", "gmres_ilu_colored", "gmres_schwarz",
                                  "gmres_amg", "gmres_shifted_laplacian", "bicgstab"])
def test_solve_helmholtz_on_card_matches_cpu(card, name):
    cfg = KrylovConfig(max_iterations=4000, tolerance=1e-8, restart=60)
    (x, info), (x_cpu, info_cpu) = (solve_helmholtz(_annulus(dev), name, cfg)
                                    for dev in (card, "cpu"))
    assert x.device.type == "cuda" and info["converged"]
    if name != "bicgstab":  # unpreconditioned BiCGStab amplifies rounding here
        assert info["iterations"] == info_cpu["iterations"]
    _close(x, x_cpu, 1e-9 if name != "bicgstab" else 1e-6)


def test_roomsim_fem_on_card_matches_cpu(card):
    from mathaudio_tpu_torch.apps.roomsim_fem import run_fem_simulation

    cfg = {
        "room": {"type": "rectangular", "width": 2.0, "depth": 2.0, "height": 2.0},
        "sources": [{"name": "s", "position": {"x": 0.5, "y": 0.5, "z": 1.0}}],
        "listening_positions": [{"x": 1.2, "y": 1.4, "z": 1.0}],
        "frequencies": {"min_freq": 50.0, "max_freq": 90.0, "num_points": 3},
        "boundaries": {"walls": {"type": "absorption", "coefficient": 0.2}},
        "solver": {"mesh_resolution": 4, "gmres": {"tolerance": 1e-6}},
    }
    for hierarchical in (False, True):
        card_run, cpu_run = (run_fem_simulation(RoomConfig.from_dict(cfg), verbose=0,
                                                hierarchical=hierarchical, dtype=F64, device=dev)
                             for dev in (card, "cpu"))
        for g, w in zip(card_run.results, cpu_run.results):
            assert (g.iterations, g.converged) == (w.iterations, True)
            np.testing.assert_allclose(g.spl_db, w.spl_db, rtol=0, atol=1e-9)


def test_bem_bicgstab_on_card_launches_the_kernel(card):
    from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
    from mathaudio_tpu_torch.bem.types import BemSolverConfig, SolverMethod
    from mathaudio_tpu_torch.ops import bem_assembly

    prob = BemProblem.rigid_sphere(1.2, subdivisions=2)
    cfg = BemSolverConfig(method=SolverMethod.BICGSTAB, burton_miller=True, tolerance=1e-10)
    bem_assembly.reset_launches()
    sol = BemSolver(cfg, dtype=F64, device=card).solve(prob)
    assert bem_assembly.LAUNCHES["burton_miller"] == 1
    ref = BemSolver(cfg, dtype=F64, device="cpu").solve(prob)
    assert sol.info["iterations"] == ref.info["iterations"] and sol.info["converged"]
    _close(sol.surface_pressure, ref.surface_pressure)
