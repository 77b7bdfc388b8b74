"""High-level BEM API (counterpart of mathaudio_tpu/bem/solver.py):
BemProblem (geometry + physics + excitation), BemSolver (dense assembly
with LU or GMRES, or the matrix-free SLFMM with GMRES), BemSolution
(surface pressure + field evaluation, dense or FMM). The FMM assemblies
are the SLFMM and, for rigid problems, the MLFMM tree; mixed problems run
the SLFMM under either, as the reference does.

The BiCGStab/CGS/QMRCGStab solvers (slice 6) and the device-mesh sharding
(slice 8) are later slices of the port; each raises a ``ValueError`` that
names its slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mathaudio_tpu_torch.bem.assembly import (
    assemble_burton_miller,
    assemble_collocation_matrix,
    assemble_mixed_system,
    bc_vectors,
)
from mathaudio_tpu_torch.bem.fmm import (
    build_mlfmm_tree_system,
    build_slfmm_mixed_system,
    build_slfmm_system,
    execution_form,
    execution_tau,
)
from mathaudio_tpu_torch.bem.incident import IncidentField, plane_wave
from mathaudio_tpu_torch.bem.mesh import SurfaceMesh, icosphere
from mathaudio_tpu_torch.bem.postprocess import FieldResult, evaluate_field, evaluate_field_fmm
from mathaudio_tpu_torch.bem.types import (
    BemMethod,
    BemSolverConfig,
    BoundaryCondition,
    PhysicsParams,
    SolverMethod,
)
from mathaudio_tpu_torch.solvers.direct import lu_solve
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres
from mathaudio_tpu_torch.solvers.preconditioners.basic import jacobi_preconditioner
from mathaudio_tpu_torch.xtypes import complex_dtype_for, default_float, resolve_device

_PORTED_METHODS = (SolverMethod.LU, SolverMethod.GMRES, SolverMethod.GMRES_ILU)


@dataclasses.dataclass
class BemProblem:
    """Scattering/radiation problem: a surface with per-element boundary
    conditions plus an optional incident field. ``bc=None`` means rigid
    (zero normal velocity everywhere); ``incident=None`` means pure
    radiation (BC excitation only)."""

    mesh: SurfaceMesh
    physics: PhysicsParams
    incident: Optional[IncidentField] = None
    bc: Optional[BoundaryCondition] = None

    @classmethod
    def rigid_sphere(cls, ka: float, radius: float = 1.0, subdivisions: Optional[int] = None,
                     incident: Optional[IncidentField] = None) -> "BemProblem":
        """Rigid sphere under a plane wave along +z (ka-based subdivision)."""
        if subdivisions is None:
            subdivisions = 2 if ka < 2.0 else 3
        return cls(
            mesh=icosphere(radius, subdivisions),
            physics=PhysicsParams.from_wave_number(ka / radius),
            incident=incident or plane_wave((0.0, 0.0, 1.0)),
        )

    @classmethod
    def radiating_sphere(cls, ka: float, radius: float = 1.0, velocity: complex = 1.0,
                         subdivisions: Optional[int] = None) -> "BemProblem":
        """Pulsating sphere: uniform radial velocity, no incident field."""
        if subdivisions is None:
            subdivisions = 2 if ka < 2.0 else 3
        mesh = icosphere(radius, subdivisions)
        return cls(
            mesh=mesh,
            physics=PhysicsParams.from_wave_number(ka / radius),
            incident=None,
            bc=BoundaryCondition.velocity(velocity, mesh.num_elements),
        )


@dataclasses.dataclass
class BemSolution:
    """Surface pressure + evaluation. ``surface_q`` (dp/dn at element
    centers) is set for non-rigid problems and feeds the single-layer
    term of the field evaluation. Fields are evaluated on the solution's
    device and in its precision."""

    problem: BemProblem
    surface_pressure: torch.Tensor  # (N,) at element centers
    info: dict
    surface_q: Optional[torch.Tensor] = None

    def evaluate_pressure(self, points, quad_order: int = 3, method: str = "dense") -> torch.Tensor:
        return self.evaluate_pressure_field(points, quad_order, method).p_total

    def evaluate_pressure_field(self, points, quad_order: int = 3,
                                method: str = "dense") -> FieldResult:
        """method='fmm' uses the O((N+M) log) clustered evaluation
        (postprocess.evaluate_field_fmm): the same result, for large grids."""
        if method not in ("dense", "fmm"):
            raise ValueError(f"unknown field evaluation method {method!r}")
        fn = evaluate_field_fmm if method == "fmm" else evaluate_field
        return fn(
            self.problem.mesh,
            self.surface_pressure,
            points,
            self.problem.physics.wave_number,
            self.problem.incident,
            quad_order=quad_order,
            dtype=self.surface_pressure.real.dtype,
            q_surf=self.surface_q,
            device=self.surface_pressure.device,
        )


class BemSolver:
    """Assembly x solver dispatch, on ``device`` (default ``cuda``; raises
    without a GPU) in ``dtype`` (default float32).

    The FMM assemblies run GMRES whatever the method (matrix-free: LU has
    nothing to factor), as the reference does, on an SLFMM or MLFMM tree
    operator built in float64 (``fmm.execution_tau``, ``fmm.execution_form``): in float64
    the reference's build (stability tau 1e8); in float32 the reference
    chip path's screen for float32 execution (tau 1e4) and a cast to
    complex64; on the GPU in its scatter-free ``gather_form``."""

    def __init__(self, config: Optional[BemSolverConfig] = None, dtype=None, device=None):
        self.config = config or BemSolverConfig()
        self.dtype = dtype or default_float()
        self.device = device

    def _check_config(self) -> None:
        cfg = self.config
        if cfg.method not in _PORTED_METHODS:
            raise ValueError(f"solver method {cfg.method.value!r} is not ported yet (slice 6, "
                             "the rest of the solvers); use LU or GMRES")
        if cfg.device_mesh is not None:
            raise ValueError("device_mesh sharding is not ported yet (slice 8, multi-GPU); "
                             "pass device_mesh=None")

    def burton_miller_beta(self, problem: BemProblem) -> complex:
        """Burton–Miller coupling: i/(k + 1/h) times the configured scale
        (or the piecewise ka rule when the scale is 0/None)."""
        cfg, ph, mesh = self.config, problem.physics, problem.mesh
        ka = ph.wave_number * mesh.ka_radius()
        scale = cfg.beta_scale or ph.optimal_beta_scale(ka)
        return ph.burton_miller_beta_optimal(mesh.avg_element_size()) * scale

    def _linear_solve(self, a, b, info: dict):
        cfg = self.config
        if cfg.method == SolverMethod.LU:
            info["converged"] = True
            return lu_solve(a, b)
        kcfg = KrylovConfig(max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
                            restart=cfg.restart)
        sol = gmres(a, b, config=kcfg, preconditioner=jacobi_preconditioner(torch.diagonal(a)))
        info["converged"] = bool(sol.converged)
        info["iterations"] = int(sol.iterations)
        return sol.x

    def solve(self, problem: BemProblem) -> BemSolution:
        if self.config.assembly in (BemMethod.SLFMM, BemMethod.MLFMM):
            if problem.bc is not None:
                return self._solve_mixed_fmm(problem)
            return self._solve_fmm(problem)
        self._check_config()
        if problem.bc is not None:
            return self._solve_mixed(problem)
        cfg = self.config
        mesh = problem.mesh
        k = problem.physics.wave_number
        device = resolve_device(self.device)
        centers = torch.tensor(mesh.centers, dtype=self.dtype, device=device)
        rhs = problem.incident.pressure(centers, k)
        if cfg.burton_miller:
            beta = self.burton_miller_beta(problem)
            a = assemble_burton_miller(mesh, k, beta, quad_order=cfg.quad_order,
                                       dtype=self.dtype, device=device)
            normals = torch.tensor(mesh.normals, dtype=self.dtype, device=device)
            rhs = rhs - beta * problem.incident.normal_derivative(centers, normals, k)
        else:
            a = assemble_collocation_matrix(mesh, k, quad_order=cfg.quad_order,
                                            dtype=self.dtype, device=device)
        info = {"method": cfg.method.value, "burton_miller": cfg.burton_miller,
                "n": mesh.num_elements}
        p = self._linear_solve(a, rhs, info)
        return BemSolution(problem, p, info)

    def _solve_mixed(self, problem: BemProblem) -> BemSolution:
        """Dense solve with per-element velocity/pressure BCs (see
        assembly.assemble_mixed_system). The solution vector mixes p
        (velocity elements) and dp/dn (pressure elements); both full
        fields are reconstructed."""
        cfg = self.config
        mesh = problem.mesh
        ph = problem.physics
        k = ph.wave_number
        beta = self.burton_miller_beta(problem) if cfg.burton_miller else 0.0
        a, b, _ = assemble_mixed_system(
            mesh, k, problem.bc, beta=beta, incident=problem.incident,
            quad_order=cfg.quad_order, density=ph.density, speed_of_sound=ph.speed_of_sound,
            dtype=self.dtype, device=self.device,
        )
        info = {"method": cfg.method.value, "burton_miller": cfg.burton_miller,
                "mixed_bc": True, "n": mesh.num_elements}
        return self._mixed_solution(problem, self._linear_solve(a, b, info), info)

    @staticmethod
    def _mixed_solution(problem: BemProblem, u, info: dict) -> BemSolution:
        """Both full surface fields from the mixed solution vector ``u``
        (p on velocity elements, dp/dn on pressure elements)."""
        ph = problem.physics
        k = ph.wave_number
        up, p_known, q_known, adm = bc_vectors(problem.bc, k, ph.density, ph.speed_of_sound,
                                               u.dtype, u.device)
        p_full = torch.where(up, u, p_known)
        q_full = torch.where(up, q_known, u)
        if getattr(problem.bc, "admittance", None) is not None:
            # velocity-with-admittance: q = i omega rho v - i k adm * p
            q_full = torch.where(up, q_known - 1j * k * adm * p_full, q_full)
        return BemSolution(problem, p_full, info, surface_q=q_full)

    def _fmm_build(self) -> dict:
        """Build keywords of the FMM paths: float64 on the solver's device,
        with the screen of the solve's precision (``fmm.execution_tau``)."""
        return dict(dtype=torch.float64, stability_tau=execution_tau(self.dtype),
                    device=resolve_device(self.device))

    def _fmm_gmres(self, op, rhs):
        """Unpreconditioned GMRES on the operator in its execution form."""
        cfg = self.config
        kcfg = KrylovConfig(max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
                            restart=cfg.restart)
        op = execution_form(op, self.dtype)
        return gmres(op.matvec, rhs.to(complex_dtype_for(self.dtype)), config=kcfg)

    def _solve_mixed_fmm(self, problem: BemProblem) -> BemSolution:
        """Matrix-free mixed-BC solve (fmm.build_slfmm_mixed_system):
        per-element velocity/pressure/admittance BCs at FMM scale. An MLFMM
        config routes here too, as in the reference (recorded in info; the
        mixed MLFMM tree is ``fmm.build_mlfmm_tree_mixed_system``); GMRES
        whatever the method."""
        cfg = self.config
        mesh = problem.mesh
        ph = problem.physics
        beta = self.burton_miller_beta(problem) if cfg.burton_miller else 0.0
        op, rhs, _ = build_slfmm_mixed_system(
            mesh, ph.wave_number, problem.bc, beta=beta, incident=problem.incident,
            density=ph.density, speed_of_sound=ph.speed_of_sound, quad_order=cfg.quad_order,
            **self._fmm_build())
        sol = self._fmm_gmres(op, rhs)
        info = {
            "method": "gmres",  # matrix-free: LU/BiCGStab configs fall back
            "assembly": BemMethod.SLFMM.value,
            "burton_miller": cfg.burton_miller,
            "mixed_bc": True,
            "n": mesh.num_elements,
            "converged": bool(sol.converged),
            "iterations": int(sol.iterations),
        }
        return self._mixed_solution(problem, sol.x, info)

    def _solve_fmm(self, problem: BemProblem) -> BemSolution:
        """Matrix-free FMM path (the SLFMM, or the MLFMM tree): CBIE with
        GMRES; Burton–Miller rides the direction-space row factors. LU is
        impossible matrix-free, so it falls back to GMRES (recorded in
        info)."""
        cfg = self.config
        mesh = problem.mesh
        k = problem.physics.wave_number
        build = self._fmm_build()
        centers = torch.tensor(mesh.centers, dtype=torch.float64, device=build["device"])
        rhs = problem.incident.pressure(centers, k)
        beta = 0.0
        if cfg.burton_miller:
            # the reference's FMM path takes ka from the mean center radius
            ka = k * float(np.linalg.norm(mesh.centers, axis=1).mean())
            scale = cfg.beta_scale or problem.physics.optimal_beta_scale(ka)
            beta = problem.physics.burton_miller_beta_optimal(mesh.avg_element_size()) * scale
            normals = torch.tensor(mesh.normals, dtype=torch.float64, device=build["device"])
            rhs = rhs - beta * problem.incident.normal_derivative(centers, normals, k)
        if cfg.assembly == BemMethod.SLFMM:
            op = build_slfmm_system(mesh, k, beta=beta, max_per_leaf=64, separation_ratio=2.0,
                                    **build)
        else:
            op = build_mlfmm_tree_system(mesh, k, beta=beta, max_per_leaf=16,
                                         separation_ratio=2.0, **build)
        sol = self._fmm_gmres(op, rhs)
        info = {
            "method": "gmres",  # matrix-free: LU falls back to GMRES
            "assembly": cfg.assembly.value,
            "burton_miller": cfg.burton_miller,
            "n": mesh.num_elements,
            "converged": bool(sol.converged),
            "iterations": int(sol.iterations),
        }
        return BemSolution(problem, sol.x, info)
