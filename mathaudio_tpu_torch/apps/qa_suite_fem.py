"""FEM QA suite (counterpart of mathaudio_tpu/apps/qa_suite_fem.py):
scattering on unstructured meshes, a 2D annulus around a rigid cylinder and
a 3D spherical shell around a rigid sphere, against the analytical series,
across the solver names of ``fem.problem.solve_helmholtz``, each writing a
ValidationResult JSON, then ``summary.json``.

Scattered-field formulation: solve for p_s with the Neumann condition
dp_s/dn = -dp_inc/dn on the obstacle and a first-order Bayliss–Turkel
radiation condition on the outer boundary; compare p_s + p_inc with the
total-field series at the nodes inside 0.8 r_outer.

The solves run on the GPU in float32 by default, on the CPU in float64
with ``--cpu``; every closed form is evaluated in float64 (the reference's
recorded run, ``qa_fem_results/``, is x64 throughout). GMRES asks for the
reference's relative tolerance 1e-8 in float64; in float32 it asks for
1e-5, since 1e-8 lies below what complex64 resolves and the solve would
run to its 4000-iteration budget.

    python -m mathaudio_tpu_torch.apps.qa_suite_fem --fast [--cpu] -o out_dir
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from mathaudio_tpu_torch.bem.testing import ExecutionMetadata, ValidationResult
from mathaudio_tpu_torch.fem import (
    HelmholtzProblem,
    NeumannBC,
    RobinBC,
    annular_mesh_triangles,
    solve_helmholtz,
    spherical_shell_mesh_tetrahedra,
)
from mathaudio_tpu_torch.solvers import KrylovConfig
from mathaudio_tpu_torch.wave.analytical.solutions_2d import rigid_cylinder_coefficients
from mathaudio_tpu_torch.wave.analytical.solutions_3d import rigid_sphere_coefficients
from mathaudio_tpu_torch.wave.special.bessel import bessel_jn_yn_all
from mathaudio_tpu_torch.wave.special.legendre import legendre_all
from mathaudio_tpu_torch.wave.special.spherical import spherical_jn_yn_all
from mathaudio_tpu_torch.xtypes import default_float, resolve_device

# Every name of fem/problem.py's dispatch, the pipelined aliases included;
# cg is left out, as in the reference: the Helmholtz system is indefinite.
SOLVERS = [
    "direct",
    "gmres",
    "gmres_jacobi",
    "gmres_ilu",
    "gmres_ilu_colored",
    "gmres_ilu_fixed_point",
    "gmres_schwarz",
    "gmres_amg",
    "gmres_shifted_laplacian",
    "gmres_pipelined",
    "gmres_pipelined_ilu",
    "gmres_pipelined_amg",
    "bicgstab",
]
# The higher-ka cylinder and the sphere, across the preconditioner families.
SECOND_SOLVERS = ["gmres_jacobi", "gmres_ilu", "gmres_amg", "gmres_shifted_laplacian"]


def _krylov(dtype) -> KrylovConfig:
    tol = 1e-8 if dtype == torch.float64 else 1e-5
    return KrylovConfig(max_iterations=4000, tolerance=tol, restart=60)


def _case(name, mesh, k, prob, solver, exact_fn, incident_axis, r_outer, out_dir, verbose,
          ka, device):
    """Solve ``prob`` by ``solver``, compare p_s + p_inc with ``exact_fn(r,
    angle)`` (float64) at the nodes inside 0.8 r_outer, write the JSON."""
    t0 = time.perf_counter()
    u, _info = solve_helmholtz(prob, solver, _krylov(prob.dtype))
    u = u.cpu().numpy()
    wall = time.perf_counter() - t0

    nodes = mesh.nodes
    r = np.linalg.norm(nodes, axis=1)
    sel = r < 0.8 * r_outer
    p_total = u[sel] + np.exp(1j * k * nodes[sel, incident_axis])
    exact = exact_fn(r[sel], nodes[sel]).cpu().numpy()
    vr = ValidationResult.create(
        name=f"{name}_ka{ka:g}_{solver}",
        positions=nodes[sel],
        computed_pressure=p_total,
        analytical_pressure=exact,
        parameters={"ka": ka, "solver": solver, "n_nodes": mesh.num_nodes},
        metadata=ExecutionMetadata(backend=device.type, wall_time_s=wall, solver=solver,
                                   num_dofs=mesh.num_nodes),
    )
    vr.save_json(os.path.join(out_dir, f"{name}_ka{ka:g}_{solver}.json"))
    if verbose:
        vr.print_summary()
    return vr


def cylinder_case(ka: float, n_radial: int, n_theta: int, solver: str, out_dir: str,
                  r_outer: float = 3.0, verbose: int = 1, *, dtype=None, device=None):
    """2D annulus: rigid cylinder r=1 under a +x plane wave, radiation
    boundary at r_outer; the solve on ``device`` (default the GPU) in
    ``dtype`` (default float32)."""
    k = ka
    device = resolve_device(device)
    mesh = annular_mesh_triangles(1.0, r_outer, n_radial, n_theta)

    def dpinc_dn(x):
        # n points out of the fluid (into the cylinder) on tag 1: -r_hat
        n_hat = -x / torch.linalg.norm(x, dim=-1, keepdim=True)
        return -(1j * k * n_hat[..., 0]) * torch.exp(1j * k * x[..., 0])

    prob = HelmholtzProblem(
        mesh, k,
        neumann=[NeumannBC(1, dpinc_dn)],
        robin=[RobinBC.absorbing_curved(2, k, r_outer, dim=2)],
        dtype=dtype or default_float(), device=device,
    )

    def exact(r, pts):
        return _cylinder_exact(k, 1.0, 40, r, np.arctan2(pts[:, 1], pts[:, 0]), device=device)

    return _case("fem_cylinder", mesh, k, prob, solver, exact, 0, r_outer, out_dir, verbose,
                 ka, device)


def _cylinder_exact(k, a, num_terms, r_pts, theta_pts, *, device=None):
    """Total field at scattered (r, theta) pairs (not a grid), float64."""
    f64 = dict(dtype=torch.float64, device=resolve_device(device))
    a_n = rigid_cylinder_coefficients(k * a, num_terms, **f64)
    j_all, y_all = bessel_jn_yn_all(num_terms - 1, torch.as_tensor(k * r_pts, **f64))
    h_all = torch.complex(j_all, y_all)  # (T, M)
    n = torch.arange(num_terms, **f64)
    eps = torch.where(n == 0, 1.0, 2.0)
    cosn = torch.cos(n[:, None] * torch.as_tensor(theta_pts, **f64)[None, :])
    scattered = torch.sum((eps * a_n)[:, None] * h_all * cosn, dim=0)
    incident = torch.exp(1j * k * torch.as_tensor(r_pts * np.cos(theta_pts), **f64))
    return incident + scattered


def sphere_case(ka: float, n_radial: int, subdivisions: int, solver: str, out_dir: str,
                r_outer: float = 2.5, verbose: int = 1, *, dtype=None, device=None):
    """3D spherical shell: rigid sphere r=1 under a +z plane wave, radiation
    boundary at r_outer."""
    k = ka
    device = resolve_device(device)
    mesh = spherical_shell_mesh_tetrahedra(1.0, r_outer, n_radial, subdivisions)

    def dpinc_dn(x):
        n_hat = -x / torch.linalg.norm(x, dim=-1, keepdim=True)
        return -(1j * k * n_hat[..., 2]) * torch.exp(1j * k * x[..., 2])

    prob = HelmholtzProblem(
        mesh, k,
        neumann=[NeumannBC(1, dpinc_dn)],
        robin=[RobinBC.absorbing_curved(2, k, r_outer, dim=3)],
        dtype=dtype or default_float(), device=device,
    )

    def exact(r, pts):
        theta = np.arccos(np.clip(pts[:, 2] / r, -1, 1))
        return _sphere_exact(k, 1.0, 40, r, theta, device=device)

    return _case("fem_sphere", mesh, k, prob, solver, exact, 2, r_outer, out_dir, verbose,
                 ka, device)


def _sphere_exact(k, a, num_terms, r_pts, theta_pts, *, device=None):
    """Total field at scattered (r, theta) pairs, float64."""
    f64 = dict(dtype=torch.float64, device=resolve_device(device))
    a_n = rigid_sphere_coefficients(k * a, num_terms, **f64)
    j_all, y_all = spherical_jn_yn_all(num_terms - 1, torch.as_tensor(k * r_pts, **f64))
    h_all = torch.complex(j_all, y_all)
    p_all = legendre_all(num_terms - 1, torch.cos(torch.as_tensor(theta_pts, **f64)))
    n = torch.arange(num_terms, **f64)
    pref = (2 * n + 1) * torch.exp(1j * n * np.pi / 2)
    return torch.sum(pref[:, None] * (j_all - a_n[:, None] * h_all) * p_all, dim=0)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="qa-suite-fem")
    ap.add_argument("-o", "--out-dir", default="qa_fem_results")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU in float64 (default: the GPU in float32)")
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args(argv)
    where = dict(dtype=torch.float64, device="cpu") if args.cpu else {}
    os.makedirs(args.out_dir, exist_ok=True)

    results = []
    solvers = ["gmres_jacobi"] if args.fast else SOLVERS
    for solver in solvers:
        results.append(cylinder_case(1.0, 24 if not args.fast else 16,
                                     96 if not args.fast else 64, solver, args.out_dir, **where))
    for solver in ["gmres_jacobi"] if args.fast else SECOND_SOLVERS:
        results.append(cylinder_case(2.0, 32 if not args.fast else 16,
                                     128 if not args.fast else 64, solver, args.out_dir, **where))
        results.append(sphere_case(1.0, 8 if not args.fast else 5, 2, solver, args.out_dir,
                                   **where))

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
