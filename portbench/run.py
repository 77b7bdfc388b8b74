"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, [breakdown], checks);
the numbers compared for ``correct`` close standard error, each beside
its limit (the harness logs them last). Exits 1, printing no result,
without a CUDA device (or with fewer than the cell asks for), if a module
of JAX or of the JAX package is loaded, or if anything else fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench.spec import ROOT


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every cache of the program stays at a fixed place in the checkout;
    # host threads stay few. Set before torch is imported.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    from portbench.harness import process_start_s

    t_start = time.perf_counter() - process_start_s()
    import torch

    from portbench import harness, spec

    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"portbench: the cell needs {cell.chips} CUDA device(s), {n} available")
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         device, t_start=t_start, log=_log)
    found = harness.forbidden_modules()
    if found:
        _log(f"portbench: modules of JAX or of the JAX package are loaded: {found}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
