"""BEM QA suite (counterpart of mathaudio_tpu/apps/qa_suite_bem.py):
rigid-sphere scattering across the Rayleigh/Mie/geometric regimes with
size-based solver selection (LU for N < 1000, GMRES above), a solver x
regime matrix, the interior rigid cavity, the pulsating sphere and the
mixed-BC pulsating sphere, each writing a ValidationResult JSON, then
``summary.json``.

The solves run on the GPU in float32 by default, on the CPU in float64
with ``--cpu``; every closed form is evaluated in float64 whatever the
solve's precision (the reference's recorded run, ``qa_bem_results/``, is
x64 throughout). The matrix's ``slfmm`` and ``mlfmm`` cases run BemSolver's
SLFMM and MLFMM tree paths; ``--fast`` runs no FMM case.

    python -m mathaudio_tpu_torch.apps.qa_suite_bem --fast [--cpu] -o out_dir
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from mathaudio_tpu_torch.bem.mesh import icosphere
from mathaudio_tpu_torch.bem.room_acoustics import solve_room_bem
from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
from mathaudio_tpu_torch.bem.testing import ExecutionMetadata, ValidationResult
from mathaudio_tpu_torch.bem.types import (
    BemMethod,
    BemSolverConfig,
    BoundaryCondition,
    PhysicsParams,
    SolverMethod,
)
from mathaudio_tpu_torch.common.source import Source
from mathaudio_tpu_torch.common.types import Point3D
from mathaudio_tpu_torch.wave.analytical import sphere_scattering_3d
from mathaudio_tpu_torch.wave.analytical.solutions_3d import pulsating_sphere_3d
from mathaudio_tpu_torch.xtypes import resolve_device

ORACLE = dict(dtype=torch.float64)  # closed forms in float64, as the recorded run


def select_solver(n: int) -> SolverMethod:
    """Size-based selection table."""
    return SolverMethod.LU if n < 1000 else SolverMethod.GMRES


# Explicit solver x assembly points of the QA matrix: the size table picks
# one per mesh; the matrix pins each solver tier to every wavenumber regime
# so regressions localize.
_SOLVER_MATRIX = {
    "lu": (SolverMethod.LU, BemMethod.TBEM),
    "gmres": (SolverMethod.GMRES, BemMethod.TBEM),
    "slfmm": (SolverMethod.GMRES, BemMethod.SLFMM),
    "mlfmm": (SolverMethod.GMRES, BemMethod.MLFMM),
}


def _solve(cfg, problem, dtype, device):
    """(surface pressure as numpy, wall seconds of the solve, the device)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    p = BemSolver(cfg, dtype=dtype, device=device).solve(problem).surface_pressure.cpu().numpy()
    return p, time.perf_counter() - t0, device


def _finish(vr, out_dir, filename, verbose):
    vr.save_json(os.path.join(out_dir, filename))
    if verbose:
        vr.print_summary()
    return vr


def sphere_case(ka: float, subdivisions: int, out_dir: str, verbose: int = 1,
                solver: str = "auto", *, dtype=None, device=None):
    prob = BemProblem.rigid_sphere(ka, subdivisions=subdivisions)
    n = prob.mesh.num_elements
    if solver == "auto":
        method, assembly = select_solver(n), BemMethod.TBEM
    else:
        method, assembly = _SOLVER_MATRIX[solver]
    cfg = BemSolverConfig(method=method, assembly=assembly, burton_miller=True)
    p, wall, device = _solve(cfg, prob, dtype, device)

    c = prob.mesh.centers
    theta = np.arccos(np.clip(c[:, 2] / np.linalg.norm(c, axis=1), -1, 1))
    exact = sphere_scattering_3d(ka, 1.0, 40, [1.0], theta, device=device, **ORACLE).pressure
    tag = "" if solver == "auto" else f"_{solver}"
    vr = ValidationResult.create(
        name=f"sphere_scattering_ka{ka:g}{tag}",
        positions=c,
        computed_pressure=p,
        analytical_pressure=exact.cpu().numpy(),
        parameters={"ka": ka, "subdivisions": subdivisions, "n_elements": n,
                    "solver": solver},
        metadata=ExecutionMetadata(
            backend=device.type,
            wall_time_s=wall,
            solver=f"{method.value}+{assembly.value}" if solver != "auto" else cfg.method.value,
            num_dofs=n,
        ),
    )
    return _finish(vr, out_dir, f"sphere_ka{ka:g}{tag}.json", verbose)


def mixed_pulsating_case(ka: float, subdivisions: int, out_dir: str, verbose: int = 1, *,
                         dtype=None, device=None):
    """Mixed velocity/pressure BC pulsating sphere: uniform radial velocity
    prescribed on the upper hemisphere, the analytic surface pressure on
    the lower one. The exact solution is the same monopole field, so the
    solved pressure (velocity elements) must match the closed form: an
    end-to-end gate on the BC-dependent column assembly."""
    mesh = icosphere(1.0, subdivisions)
    n = mesh.num_elements
    device = resolve_device(device)
    exact = pulsating_sphere_3d(ka, 1.0, mesh.centers, device=device, **ORACLE)
    exact = exact.pressure.cpu().numpy()
    upper = mesh.centers[:, 2] >= 0.0
    prob = BemProblem(
        mesh=mesh,
        physics=PhysicsParams.from_wave_number(ka),
        incident=None,
        bc=BoundaryCondition(types=np.where(upper, 0, 1).astype(np.int32),
                             values=np.where(upper, 1.0 + 0.0j, exact)),
    )
    cfg = BemSolverConfig(method=SolverMethod.LU, burton_miller=True)
    p, wall, device = _solve(cfg, prob, dtype, device)
    vr = ValidationResult.create(
        name=f"mixed_pulsating_sphere_ka{ka:g}",
        positions=mesh.centers,
        computed_pressure=p,
        analytical_pressure=exact,
        parameters={"ka": ka, "subdivisions": subdivisions, "n_elements": n,
                    "n_velocity": int(upper.sum()), "n_pressure": int((~upper).sum())},
        metadata=ExecutionMetadata(backend=device.type, wall_time_s=wall, solver="lu+mixed",
                                   num_dofs=n),
    )
    return _finish(vr, out_dir, f"mixed_pulsating_ka{ka:g}.json", verbose)


def cavity_case(ka: float, subdivisions: int, out_dir: str, verbose: int = 1, *, dtype=None,
                device=None):
    """Interior rigid cavity with a central monopole vs the closed form
    G(a) + A j0(ka), A such that dp/dr vanishes on the wall."""
    a = 1.0
    k = ka / a
    f = k * 343.0 / (2 * np.pi)
    mesh = icosphere(a, subdivisions)
    src = Source.omnidirectional(Point3D(0.0, 0.0, 0.0), 1.0)
    device = resolve_device(device)
    t0 = time.perf_counter()
    sol = solve_room_bem(mesh, f, [src], admittance=0.0, method="lu", dtype=dtype, device=device)
    p = sol.surface_pressure.cpu().numpy()
    wall = time.perf_counter() - t0
    gp = (1j * k - 1 / a) * np.exp(1j * k * a) / (4 * np.pi * a)
    j0p = (ka * np.cos(ka) - np.sin(ka)) / ka**2
    amp = -gp / (k * j0p)
    exact = np.full(mesh.num_elements,
                    np.exp(1j * k * a) / (4 * np.pi * a) + amp * np.sin(ka) / ka)
    vr = ValidationResult.create(
        name=f"cavity_monopole_ka{ka:g}",
        positions=mesh.centers,
        computed_pressure=p,
        analytical_pressure=exact,
        parameters={"ka": ka, "subdivisions": subdivisions},
        metadata=ExecutionMetadata(backend=device.type, wall_time_s=wall, solver="lu",
                                   num_dofs=mesh.num_elements),
    )
    return _finish(vr, out_dir, f"cavity_ka{ka:g}.json", verbose)


def pulsating_case(ka: float, subdivisions: int, out_dir: str, verbose: int = 1, *, dtype=None,
                   device=None):
    """Radiating pulsating sphere, v0 = 1 m/s, vs the analytic monopole
    surface pressure."""
    prob = BemProblem.radiating_sphere(ka, subdivisions=subdivisions)
    n = prob.mesh.num_elements
    cfg = BemSolverConfig(method=select_solver(n), burton_miller=True)
    p, wall, device = _solve(cfg, prob, dtype, device)
    exact = pulsating_sphere_3d(ka, 1.0, prob.mesh.centers, device=device, **ORACLE).pressure
    vr = ValidationResult.create(
        name=f"pulsating_sphere_ka{ka:g}",
        positions=prob.mesh.centers,
        computed_pressure=p,
        analytical_pressure=exact.cpu().numpy(),
        parameters={"ka": ka, "subdivisions": subdivisions, "n_elements": n},
        metadata=ExecutionMetadata(backend=device.type, wall_time_s=wall,
                                   solver=cfg.method.value, num_dofs=n),
    )
    return _finish(vr, out_dir, f"pulsating_ka{ka:g}.json", verbose)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="qa-suite-bem")
    ap.add_argument("-o", "--out-dir", default="qa_bem_results")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU in float64 (default: the GPU in float32)")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--fast", action="store_true", help="coarse meshes only")
    args = ap.parse_args(argv)
    where = dict(dtype=torch.float64, device="cpu") if args.cpu else {}
    os.makedirs(args.out_dir, exist_ok=True)

    results = []
    cases = [(0.1, 2), (0.5, 2), (1.0, 2), (2.0, 3), (np.pi, 3), (5.0, 3)]
    if args.fast:
        cases = [(0.5, 2), (1.0, 2), (2.0, 2)]
    for ka, sub in cases:
        results.append(sphere_case(ka, sub, args.out_dir, **where))
    if not args.fast:
        # solver x regime matrix: every solver tier at a Rayleigh, Mie and
        # geometric wavenumber
        for solver in ["lu", "gmres", "slfmm", "mlfmm"]:
            for ka, sub in [(0.5, 2), (2.0, 3), (5.0, 3)]:
                results.append(sphere_case(ka, sub, args.out_dir, solver=solver, **where))
    for ka in [1.0, 2.0]:
        results.append(cavity_case(ka, 3 if not args.fast else 2, args.out_dir, **where))
    for ka in [0.5, 1.0] if args.fast else [0.5, 1.0, 2.0, np.pi]:
        results.append(pulsating_case(ka, 2, args.out_dir, **where))
    results.append(mixed_pulsating_case(1.0, 3 if not args.fast else 2, args.out_dir, **where))

    passed = [r.passed(args.threshold) for r in results]
    summary = {
        "total": len(results),
        "passed": int(sum(passed)),
        "threshold": args.threshold,
        "cases": [
            {"name": r.name, "rel_l2": r.metrics.l2_relative, "passed": bool(p)}
            for r, p in zip(results, passed)
        ],
    }
    with open(os.path.join(args.out_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary["cases"], indent=1))
    return 0 if all(passed) else 1


if __name__ == "__main__":
    sys.exit(main())
