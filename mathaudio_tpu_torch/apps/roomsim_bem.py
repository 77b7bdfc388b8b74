"""BEM room simulator CLI (counterpart of mathaudio_tpu/apps/roomsim_bem.py):
RoomConfig JSON -> surface mesh -> interior BEM solve per frequency ->
SPL at listening positions -> SimulationResults JSON.

The tier follows the reference's table: ``--solver`` overrides it;
otherwise a "direct" method or N < 1000 elements gives the dense LU, a
method containing "fmm" or N >= 4000 the FMM tier, anything else
Jacobi-preconditioned GMRES. The FMM tier is slice 5 of the port and
raises a ``ValueError`` before any assembly. The dense tiers and the field
evaluation run on the GPU in float32 by default; ``--cpu`` runs them on the
CPU in float64 (the reference's ``--cpu``: CPU platform and x64).

    python -m mathaudio_tpu_torch.apps.roomsim_bem configs/small_room.json [--cpu] [-o out.json]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mathaudio_tpu_torch.bem.room_acoustics import solve_room_bem
from mathaudio_tpu_torch.common.config import RoomConfig
from mathaudio_tpu_torch.common.output import create_output_json
from mathaudio_tpu_torch.utils.profiling import span
from mathaudio_tpu_torch.xtypes import default_float, pressure_to_spl, resolve_device

SOLVERS = ["auto", "direct", "gmres", "gmres-ilu", "fmm", "fmm-ilu", "fmm-batched"]


def solver_tier(config: RoomConfig, n: int, solver: str = "auto") -> str:
    """"lu" or "gmres" by the reference's table (the ``--solver`` override,
    else the config's method and the element count ``n``). The FMM tier
    raises a ValueError naming its slice."""
    if solver != "auto":
        t = solver.replace("_", "-")
        if t in ("direct", "lu"):
            return "lu"
        if t in ("gmres", "gmres-ilu", "gmres-jacobi"):
            return "gmres"
        if t not in ("fmm", "fmm-ilu", "fmm-batched"):
            raise SystemExit(f"unknown solver {solver!r}")
        why = f"--solver {solver}"
    elif config.solver.method == "direct" or n < 1000:
        return "lu"
    elif "fmm" in config.solver.method or n >= 4000:
        why = (f"the method {config.solver.method!r}" if "fmm" in config.solver.method
               else f"N = {n} >= 4000 elements")
    else:
        return "gmres"
    raise ValueError(f"{why} selects the FMM tier, which is not ported yet (slice 5, FMM); "
                     "pass solver='gmres' or 'direct' for a dense tier")


def run_bem_simulation(config: RoomConfig, verbose: int = 1, solver: str = "auto", *,
                       dtype=None, device=None):
    """Every frequency of ``config`` through ``solve_room_bem`` and the
    field at the listening positions, on ``device`` (default the GPU;
    raises without one) in ``dtype`` (default float32). Besides the
    reference's fields, each result records its GMRES iterations (0 for
    LU)."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    sim = config.to_simulation()
    with span("surface mesh", verbose):
        mesh = sim.geometry.generate_mesh(config.solver.mesh_resolution).to_surface_mesh()
    if verbose:
        print(f"surface mesh: {mesh.num_elements} elements", file=sys.stderr)
    # mean normalized wall admittance beta of the six walls' specs: an
    # absorption coefficient a gives (1 - sqrt(1 - a)) / (1 + sqrt(1 - a)),
    # an impedance z gives Re(1/z), a rigid wall 0
    betas = []
    for s in config.boundaries.wall_specs().values():
        if s.kind == "absorption":
            root = np.sqrt(1 - min(max(s.coefficient, 0.0), 0.9999))
            betas.append((1 - root) / (1 + root))
        elif s.kind == "impedance" and s.impedance != 0:
            betas.append((1.0 / s.impedance).real)
        else:
            betas.append(0.0)
    beta = float(np.mean(betas))
    method = solver_tier(config, mesh.num_elements, solver)
    lp = np.asarray([p.to_array() for p in sim.listening_positions])

    all_p = np.zeros((len(sim.frequencies), len(lp)), complex)
    conv, iters, times = [], [], []
    for fi, f in enumerate(sim.frequencies):
        t0 = time.perf_counter()
        sol = solve_room_bem(mesh, float(f), sim.sources, admittance=beta, method=method,
                             dtype=dtype, device=device)
        p = sol.evaluate_pressure(lp).cpu().numpy()  # waits for the device
        all_p[fi] = p
        conv.append(bool(sol.info.get("converged", True)))
        iters.append(int(sol.info.get("iterations", 0)))
        times.append(time.perf_counter() - t0)
        if verbose:
            print(f"  f={f:7.1f} Hz |p|={np.abs(p).round(5).tolist()} ({times[-1]:.2f}s)",
                  file=sys.stderr)

    spl = pressure_to_spl(np.abs(all_p)).numpy()
    results = create_output_json(
        config,
        sim.frequencies,
        spl,
        extra_metadata={
            "engine": "bem",
            "num_elements": int(mesh.num_elements),
            "wall_admittance": beta,
            "converged": conv,
            "avg_solve_time_s": float(np.mean(times)),
        },
    )
    for i, r in enumerate(results.results):
        r.converged = conv[i]
        r.iterations = iters[i]
        r.solve_time_s = times[i]
        r.pressure_real = all_p[i].real.tolist()
        r.pressure_imag = all_p[i].imag.tolist()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="roomsim", description="BEM room simulator (PyTorch/CUDA)")
    ap.add_argument("config")
    ap.add_argument("-o", "--output", default="room_bem_results.json")
    ap.add_argument("-v", "--verbose", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64 (default: the GPU in float32)")
    ap.add_argument("--solver", default="auto", choices=SOLVERS,
                    help="override the size-based solver table (the fmm choices are slice 5)")
    ap.add_argument("--mesh-resolution", type=int, default=None,
                    help="surface elements per meter")
    args = ap.parse_args(argv)
    where = dict(dtype=torch.float64, device="cpu") if args.cpu else {}
    config = RoomConfig.from_file(args.config)
    if args.mesh_resolution:
        config.solver.mesh_resolution = args.mesh_resolution
    results = run_bem_simulation(config, verbose=args.verbose, solver=args.solver, **where)
    results.save(args.output)
    if args.verbose:
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
