"""DE optimizer CLI (counterpart of mathaudio_tpu/apps/run_de.py;
math-differential-evolution/bin/run_de.rs): optimize a registered test
function, print a JSON report, optionally record a per-evaluation CSV
trace. The population lives on ``--device`` (the GPU by default)."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mathaudio_tpu_torch.optim import (
    DEConfig,
    Mutation,
    PolishConfig,
    Strategy,
    differential_evolution,
)
from mathaudio_tpu_torch.optim.recorder import run_recorded_differential_evolution
from mathaudio_tpu_torch.testfunctions import FUNCTIONS, list_functions


def main(argv=None):
    ap = argparse.ArgumentParser(prog="run-de")
    ap.add_argument("function", nargs="?", help="registered test function name")
    ap.add_argument("--list", action="store_true", help="list registered functions")
    ap.add_argument("--strategy", default="best1bin")
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--popsize", type=int, default=15)
    ap.add_argument("--tol", type=float, default=1e-2)
    ap.add_argument("--recombination", type=float, default=0.7)
    ap.add_argument("--mutation", type=float, nargs=2, default=None, metavar=("MIN", "MAX"))
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--dims", type=int, default=None, help="override dimensionality")
    ap.add_argument("--record", default=None, help="CSV trace path")
    ap.add_argument("--polish", action="store_true")
    ap.add_argument("--jit-loop", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device for the population (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)

    if args.list or not args.function:
        for name in list_functions():
            fn, meta = FUNCTIONS[name]
            dims = meta.dimensions or "any"
            print(f"{name:36s} dims={dims} multimodal={meta.multimodal}")
        return 0

    fn, meta = FUNCTIONS[args.function]
    bounds = list(meta.bounds)
    if args.dims:
        bounds = [bounds[0]] * args.dims

    cfg = DEConfig(
        maxiter=args.maxiter,
        popsize=args.popsize,
        tol=args.tol,
        recombination=args.recombination,
        strategy=Strategy.from_str(args.strategy),
        seed=args.seed,
    )
    if args.mutation:
        cfg.mutation = Mutation.range_of(*args.mutation)
    if args.polish:
        cfg.polish = PolishConfig(enabled=True)
    for g in meta.inequality_constraints:
        cfg.penalty_ineq.append((g, 1e6))

    if args.record:
        report, _ = run_recorded_differential_evolution(fn, bounds, args.record, config=cfg,
                                                        device=args.device)
    else:
        report = differential_evolution(fn, bounds, config=cfg, jit_loop=args.jit_loop,
                                        device=args.device)

    expected = meta.global_minima[0][1] if meta.global_minima else None
    print(
        json.dumps(
            {
                "function": args.function,
                "x": np.asarray(report.x).tolist(),
                "fun": report.fun,
                "expected_minimum": expected,
                "success": report.success,
                "message": report.message,
                "nit": report.nit,
                "nfev": report.nfev,
            },
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
