"""The assembled Helmholtz problem and its solver dispatch (counterpart of
mathaudio_tpu/fem/problem.py).

``HelmholtzProblem`` assembles (K - k^2 M + Robin) u = b with its boundary
conditions once, on the problem's device in its precision.
``solve_helmholtz`` dispatches the reference's solver names (and their
aliases) to the port's Krylov solvers and preconditioners: the direct LU,
GMRES unpreconditioned or with Jacobi, the fixed-point or the colored
ILU(0), additive Schwarz, AMG or the shifted-Laplacian AMG, BiCGStab and
CG. Set-ups (ILU factors, colorings, Schwarz partitions, AMG hierarchies)
run on the host; every apply runs on the problem's device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from mathaudio_tpu_torch.fem.assembly import HelmholtzAssembler, assemble_rhs
from mathaudio_tpu_torch.fem.boundary import (
    DirichletBC,
    NeumannBC,
    RobinBC,
    dirichlet_mask_and_values,
    surface_load,
)
from mathaudio_tpu_torch.fem.mesh import Mesh
from mathaudio_tpu_torch.solvers.direct import lu_solve
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, bicgstab, cg, gmres
from mathaudio_tpu_torch.solvers.preconditioners import (
    AdditiveSchwarz,
    AmgConfig,
    AmgPreconditioner,
    IluColored,
    IluFixedPoint,
    jacobi_preconditioner,
)
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix
from mathaudio_tpu_torch.xtypes import complex_dtype_for, default_float, resolve_device

# The reference's aliases: its pipelined variants are the plain solvers.
_ALIASES = {
    "gmres_pipelined": "gmres",
    "gmres_pipelined_ilu": "gmres_ilu",
    "gmres_ilu_coloring": "gmres_ilu_colored",
    "gmres_ilu_fixed_point": "gmres_ilu",
    "gmres_pipelined_amg": "gmres_amg",
}


class HelmholtzProblem:
    """Assembled Helmholtz system (K - k^2 M [+ Robin]) u = b with BCs, on
    ``device`` (default ``cuda``) in ``dtype`` (default float32)."""

    def __init__(
        self,
        mesh: Mesh,
        wave_number: float,
        source_fn: Optional[Callable] = None,
        dirichlet: Sequence[DirichletBC] = (),
        neumann: Sequence[NeumannBC] = (),
        robin: Sequence[RobinBC] = (),
        dtype=None,
        *,
        device=None,
    ):
        self.mesh = mesh
        self.k = wave_number
        dtype = dtype or default_float()
        self.dtype = dtype
        self.cdtype = complex_dtype_for(dtype)
        self.device = device = resolve_device(device)

        self.assembler = HelmholtzAssembler(mesh, robin_tags=[bc.tag for bc in robin],
                                            dtype=dtype, device=device)
        self.robin_coeffs = {bc.tag: bc.alpha for bc in robin}

        rhs = torch.zeros(mesh.num_nodes, dtype=self.cdtype, device=device)
        if source_fn is not None:
            rhs = rhs + assemble_rhs(mesh, source_fn, dtype=dtype, device=device).to(self.cdtype)
        for bc in neumann:
            rhs = rhs + surface_load(mesh, bc.tag, bc.flux, cdtype=self.cdtype, device=device)
        for bc in robin:
            if bc.g is not None:
                rhs = rhs + surface_load(mesh, bc.tag, bc.g, cdtype=self.cdtype, device=device)
        self.rhs_raw = rhs

        if dirichlet:
            self.constrained, self.g = dirichlet_mask_and_values(mesh, dirichlet, self.cdtype,
                                                                 device=device)
        else:
            self.constrained = torch.zeros(mesh.num_nodes, dtype=torch.bool, device=device)
            self.g = torch.zeros(mesh.num_nodes, dtype=self.cdtype, device=device)

        self._vals_raw = self.assembler.system_values(self.k, self.robin_coeffs)
        self.rhs = self.assembler.dirichlet_rhs(
            self._vals_raw, self.rhs_raw, self.constrained, self.g
        )
        self.vals = self.assembler.apply_dirichlet_values(self._vals_raw, self.constrained)
        self.operator = self.assembler.operator_from_values(self.vals)

    def to_dense(self):
        """Dense system matrix (small problems, the direct solver)."""
        n = self.mesh.num_nodes
        asm = self.assembler
        a = torch.zeros((n, n), dtype=self.vals.dtype, device=self.vals.device)
        return a.index_put_((asm.row_of_slot.long(), asm.col_of_slot.long()), self.vals,
                            accumulate=True)

    def diagonal(self):
        return self.assembler.diagonal_of(self.vals)

    def _csr(self, vals=None) -> CsrMatrix:
        """The system (or ``vals`` on its sparsity) as a host CSR matrix."""
        asm = self.assembler
        vals = self.vals if vals is None else vals
        return CsrMatrix(asm.csr.indptr, asm.csr.indices, vals.cpu().numpy(), asm.csr.shape)


def _shifted_laplacian(problem: HelmholtzProblem):
    """Host CSR matrix of K - (1 + 0.5i) k^2 M + Robin with the Dirichlet rows and
    columns eliminated: Erlangga's shifted Laplacian, which AMG can
    approximately invert."""
    asm, cd = problem.assembler, problem.cdtype
    k = problem.k
    vals = asm.k_vals.to(cd) - (1.0 + 0.5j) * (k**2) * asm.m_vals.to(cd)
    for tag, coeff in problem.robin_coeffs.items():
        vals = vals + coeff * asm.b_vals[tag].to(cd)
    return problem._csr(asm.apply_dirichlet_values(vals, problem.constrained))


def solve_helmholtz(
    problem: HelmholtzProblem,
    solver: str = "gmres_jacobi",
    config: Optional[KrylovConfig] = None,
    x0=None,
):
    """Solve by name: direct, gmres, gmres_jacobi, gmres_ilu (fixed-point),
    gmres_ilu_colored (exact sweeps by color), gmres_schwarz, gmres_amg,
    gmres_shifted_laplacian (an AMG V-cycle on the complex-shifted
    operator), bicgstab, cg, and the aliases gmres_pipelined[_ilu|_amg],
    gmres_ilu_coloring, gmres_ilu_fixed_point. A name it does not know runs
    unpreconditioned GMRES, as in the reference. Returns (x, info)."""
    config = config or KrylovConfig(max_iterations=2000, tolerance=1e-10, restart=50)
    a = problem.operator
    b = problem.rhs
    solver = _ALIASES.get(solver, solver)
    dev = problem.device

    if solver == "direct":
        x = lu_solve(problem.to_dense(), b)
        return x, {"solver": solver, "converged": True, "iterations": 0}

    pre = None
    if solver == "gmres_shifted_laplacian":
        pre = AmgPreconditioner(_shifted_laplacian(problem), AmgConfig.for_difficult_problems(),
                                dtype=problem.dtype, device=dev)
    elif solver == "gmres_jacobi":
        pre = jacobi_preconditioner(problem.diagonal())
    elif solver == "gmres_ilu":
        pre = IluFixedPoint.from_csr(problem._csr(), sweeps=6, device=dev)
    elif solver == "gmres_ilu_colored":
        pre = IluColored.from_csr(problem._csr(), device=dev)
    elif solver == "gmres_schwarz":
        n_sub = max(2, problem.mesh.num_nodes // 512)
        pre = AdditiveSchwarz.from_csr(problem._csr(), num_subdomains=n_sub, overlap=1, device=dev)
    elif solver == "gmres_amg":
        pre = AmgPreconditioner(problem._csr(), AmgConfig.for_fem(), dtype=problem.dtype,
                                device=dev)

    if solver == "cg":
        sol = cg(a, b, x0=x0, config=config, preconditioner=pre)
    elif solver == "bicgstab":
        sol = bicgstab(a, b, x0=x0, config=config, preconditioner=pre)
    else:
        sol = gmres(a, b, x0=x0, config=config, preconditioner=pre)

    info = {
        "solver": solver,
        "converged": bool(sol.converged),
        "iterations": int(sol.iterations),
        "residual": float(sol.residual_norm),
    }
    return sol.x, info


def l2_error_at_nodes(mesh: Mesh, u, exact_fn):
    """Relative nodal L2 error of ``u`` against ``exact_fn`` at the nodes
    (taken in ``u``'s real precision on its device)."""
    exact = exact_fn(torch.as_tensor(mesh.nodes, dtype=u.real.dtype, device=u.device))
    diff = u - exact.to(u.dtype)
    num = torch.sqrt(torch.sum(torch.abs(diff) ** 2))
    den = torch.sqrt(torch.sum(torch.abs(exact) ** 2))
    return torch.where(den > 1e-15, num / torch.where(den > 1e-15, den, 1.0), num)
