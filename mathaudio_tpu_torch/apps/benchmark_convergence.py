"""Strategy x function convergence benchmark harness (counterpart of
mathaudio_tpu/apps/benchmark_convergence.py) — the rebuild of the
reference's 2013-line sweep
(math-differential-evolution/bench/benchmark_convergence.rs): named
benchmark configs over the full test-function registry (plus
higher-dimension variants), per-eval CSV traces through the recorder,
per-benchmark PASS/FAIL against fun/position tolerances, and a summary
table with success rates and nfev statistics.

Differences by design: the reference hand-writes ~180 BenchmarkConfig
blocks; here the registry metadata generates them (native-dimension
benchmark for every function with a known optimum; 5d/10d variants for
functions that provably keep a zero minimum at a replicated optimum —
checked numerically at generation time, not assumed).

Every DE run's population lives on ``--device`` (the GPU by default).

Usage:
    python -m mathaudio_tpu_torch.apps.benchmark_convergence --list
    python -m mathaudio_tpu_torch.apps.benchmark_convergence -f rastrigin -v
    python -m mathaudio_tpu_torch.apps.benchmark_convergence --quick [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from mathaudio_tpu_torch.optim import DEConfig, Strategy
from mathaudio_tpu_torch.optim.recorder import run_recorded_differential_evolution
from mathaudio_tpu_torch.testfunctions import FUNCTIONS
from mathaudio_tpu_torch.xtypes import resolve_device


@dataclasses.dataclass
class BenchmarkConfig:
    """benchmark_convergence.rs:335 BenchmarkConfig analog."""

    name: str
    function_name: str
    bounds: List[Tuple[float, float]]
    expected_optimum: Optional[List[float]]  # None = fun check only
    expected_fun: float
    fun_tolerance: float
    position_tolerance: float
    maxiter: int
    popsize: int
    strategy: Strategy
    recombination: float
    seed: int


@dataclasses.dataclass
class BenchmarkResult:
    """benchmark_convergence.rs:1794 BenchmarkResult analog."""

    name: str
    success: bool
    fun_value: float
    fun_error: float
    fun_tolerance: float
    max_position_error: float
    position_tolerance: float
    nit: int
    nfev: int
    wall_s: float
    strategy: str
    error_message: Optional[str] = None

    def line(self) -> str:
        status = "PASS" if self.success else "FAIL"
        msg = f" - {self.error_message}" if self.error_message else ""
        return (
            f"{status} {self.name:32s} f={self.fun_value:+.4e} "
            f"(err {self.fun_error:.2e} < {self.fun_tolerance:.0e}, "
            f"pos {self.max_position_error:.3f} < {self.position_tolerance}, "
            f"nfev {self.nfev}, {self.wall_s:.1f}s){msg}"
        )


# Per-dimension defaults (mirroring the reference's hand-tuned spread:
# multimodal functions get exploratory strategies and bigger budgets).
def _default_strategy(multimodal: bool, ndim: int) -> Strategy:
    if multimodal:
        return Strategy.RAND1BIN if ndim >= 5 else Strategy.RANDTOBEST1BIN
    return Strategy.BEST1BIN


def generate_all_benchmarks(seed: int = 42, quick: bool = False) -> List[BenchmarkConfig]:
    """benchmark_convergence.rs:351 generate_all_benchmarks, driven by
    registry metadata instead of hand-written blocks."""
    configs: List[BenchmarkConfig] = []
    scale = 0.25 if quick else 1.0
    for fname in sorted(FUNCTIONS):
        fn, meta = FUNCTIONS[fname]
        if not meta.global_minima:
            continue
        if meta.inequality_constraints or meta.equality_constraints:
            # constrained functions are exercised by run_de / tests; the
            # convergence harness sweeps the unconstrained registry
            continue
        ndim = len(meta.bounds)
        x_star, f_star = meta.global_minima[0]
        multim = bool(meta.multimodal)
        fun_tol = 1e-2 if multim else 1e-4
        pos_tol = 0.5 if multim else 0.2
        maxiter = int((1200 if multim else 600) * scale)
        popsize = 40 if ndim <= 4 else 80
        # position check only when a unique optimum is listed
        pos = list(map(float, x_star)) if len(meta.global_minima) == 1 else None
        configs.append(
            BenchmarkConfig(
                name=f"{fname}_{ndim}d",
                function_name=fname,
                bounds=[tuple(b) for b in meta.bounds],
                expected_optimum=pos,
                expected_fun=float(f_star),
                fun_tolerance=fun_tol,
                position_tolerance=pos_tol,
                maxiter=maxiter,
                popsize=popsize,
                strategy=_default_strategy(multim, ndim),
                recombination=0.9 if multim else 0.7,
                seed=seed,
            )
        )
        # nd variants for dimension-generic zero-minimum functions:
        # optimum must be a replicated coordinate and the function must
        # actually evaluate to ~0 there in higher dimension (verified,
        # not assumed — sum-style minima like schwefel scale with n).
        if (
            ndim == 2
            and abs(float(f_star)) < 1e-12
            and len(set(np.round(np.asarray(x_star, float), 12))) == 1
        ):
            for nd in (5, 10):
                x_nd = torch.full((nd,), float(x_star[0]), dtype=torch.float64)
                try:
                    ok = abs(float(fn(x_nd))) < 1e-9
                except Exception:
                    ok = False
                if not ok:
                    continue
                configs.append(
                    BenchmarkConfig(
                        name=f"{fname}_{nd}d",
                        function_name=fname,
                        bounds=[tuple(meta.bounds[0])] * nd,
                        expected_optimum=[float(x_star[0])] * nd,
                        expected_fun=0.0,
                        fun_tolerance=1e-2 if multim else 1e-4,
                        position_tolerance=0.5,
                        maxiter=int((1600 if multim else 800) * scale),
                        popsize=100,
                        strategy=_default_strategy(multim, nd),
                        recombination=0.95,
                        seed=seed + nd,
                    )
                )
    return configs


def run_benchmark(cfg: BenchmarkConfig, out_dir: str,
                  strategy_override: Optional[Strategy] = None, *,
                  device=None) -> BenchmarkResult:
    """benchmark_convergence.rs:1827 run_benchmark: recorded solve +
    fun/position validation, the population on ``device``."""
    fn, _ = FUNCTIONS[cfg.function_name]
    strategy = strategy_override or cfg.strategy
    de_cfg = DEConfig(
        maxiter=cfg.maxiter,
        popsize=cfg.popsize,
        recombination=cfg.recombination,
        strategy=strategy,
        seed=cfg.seed,
        tol=0.0,  # run the full budget; success judged on tolerances
    )
    csv_path = os.path.join(out_dir, f"{cfg.name}_{strategy.value}.csv")
    t0 = time.perf_counter()
    try:
        rep, _rows = run_recorded_differential_evolution(fn, cfg.bounds, csv_path, de_cfg,
                                                         device=device)
    except Exception as e:  # a crash is a FAIL row, not a harness abort
        return BenchmarkResult(
            name=cfg.name, success=False, fun_value=float("inf"),
            fun_error=float("inf"), fun_tolerance=cfg.fun_tolerance,
            max_position_error=float("inf"),
            position_tolerance=cfg.position_tolerance, nit=0, nfev=0,
            wall_s=time.perf_counter() - t0, strategy=strategy.value,
            error_message=f"optimization failed: {e}",
        )
    wall = time.perf_counter() - t0
    fun_err = abs(rep.fun - cfg.expected_fun)
    fun_ok = fun_err < cfg.fun_tolerance
    if cfg.expected_optimum is not None:
        pos_err = float(np.max(np.abs(np.asarray(rep.x) - cfg.expected_optimum)))
        pos_ok = pos_err < cfg.position_tolerance
    else:
        pos_err, pos_ok = 0.0, True
    msgs = []
    if not fun_ok:
        msgs.append(f"fun error {fun_err:.3e} >= {cfg.fun_tolerance:.0e}")
    if not pos_ok:
        msgs.append(f"max position error {pos_err:.3f} >= {cfg.position_tolerance}")
    return BenchmarkResult(
        name=cfg.name, success=fun_ok and pos_ok, fun_value=float(rep.fun),
        fun_error=fun_err, fun_tolerance=cfg.fun_tolerance,
        max_position_error=pos_err, position_tolerance=cfg.position_tolerance,
        nit=rep.nit, nfev=rep.nfev, wall_s=wall, strategy=strategy.value,
        error_message=", ".join(msgs) or None,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark-convergence")
    ap.add_argument("-o", "--out-dir", default="de_benchmark")
    ap.add_argument("-f", "--filter", default=None,
                    help="only run benchmarks whose name contains PATTERN")
    ap.add_argument("-l", "--list", action="store_true",
                    help="list available benchmarks and exit")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--strategies", nargs="*", default=None,
                    help="override: run EVERY benchmark with each of these "
                         "strategies (success-rate table per strategy)")
    ap.add_argument("--quick", action="store_true",
                    help="quarter iteration budgets (smoke run)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device for the populations (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)

    configs = generate_all_benchmarks(seed=args.seed, quick=args.quick)
    if args.filter:
        configs = [c for c in configs if args.filter in c.name]
    if args.list:
        for c in configs:
            print(f"{c.name:32s} {len(c.bounds)}d {c.strategy.value:20s} "
                  f"maxiter={c.maxiter} popsize={c.popsize}")
        print(f"{len(configs)} benchmarks")
        return 0
    device = resolve_device(args.device)  # no card and no --device: raise, not FAIL rows
    os.makedirs(args.out_dir, exist_ok=True)

    strategies = (
        [Strategy.from_str(s) for s in args.strategies] if args.strategies else [None]
    )
    all_results: List[BenchmarkResult] = []
    for strat in strategies:
        for cfg in configs:
            res = run_benchmark(cfg, args.out_dir, strat, device=device)
            all_results.append(res)
            if args.verbose or not res.success:
                print(res.line(), file=sys.stderr)

    # summary: per-strategy success rate + nfev stats (the reference's
    # closing table)
    print("\n=== summary ===")
    by_strategy = {}
    for r in all_results:
        by_strategy.setdefault(r.strategy, []).append(r)
    for sname, rs in sorted(by_strategy.items()):
        n_pass = sum(r.success for r in rs)
        nfevs = [r.nfev for r in rs if r.success]
        print(
            f"{sname:22s} {n_pass}/{len(rs)} pass "
            f"({100.0 * n_pass / len(rs):.0f}%), nfev on solved: "
            f"median {int(np.median(nfevs)) if nfevs else '-'}, "
            f"mean {int(np.mean(nfevs)) if nfevs else '-'}"
        )
    with open(os.path.join(args.out_dir, "summary.json"), "w") as fh:
        json.dump([dataclasses.asdict(r) for r in all_results], fh, indent=2)
    total_pass = sum(r.success for r in all_results)
    print(f"TOTAL: {total_pass}/{len(all_results)} pass; traces + summary.json "
          f"in {args.out_dir}/")
    return 0 if total_pass == len(all_results) else 1


if __name__ == "__main__":
    sys.exit(main())
