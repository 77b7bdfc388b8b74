"""The readings a cell's limits are set from, at the cell's own sizes.

    python3 -m portbench.readings --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3]

For each of ``--seeds``: the program built for that seed's traffic, as
many sweeps as a run compares, and the check's numbers (the lower
readings). For each of ``--control-seeds``: the same sample answered by
the plain reference put in the program's place with every product's
operands rounded to the next precision below the configuration's (the
upper readings): the configurations state float32 products with TF32
off, so the control rounds them to TF32. One JSON line per reading on
standard output. A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import spec
from portbench.spec import ROOT
from portbench.harness import sync
from portbench.precision import tf32
from portbench.traffic import Traffic


def program_reading(cell, sut, seed: int, device) -> dict:
    traffic = Traffic(cell.traffic, seed)
    system = sut.System(cell.config, traffic, device)
    system.run(traffic.warm(0))
    count = int(cell.traffic["check"]["sweeps"])
    outputs = {i: system.run(traffic.sweep(i)) for i in range(count)}
    summaries = [system.summary(o) for o in outputs.values()]
    failed = sum(s["failed"] for s in summaries)
    iters = sum(s.get("iterations", 0.0) for s in summaries) / sum(s["lanes"] for s in summaries)
    sync(device)
    del system
    gc.collect()
    torch.cuda.empty_cache()
    readings = sut.check(cell.config, traffic, outputs, traffic.check_sample(count), device)
    return {"seed": seed, "side": "program", "failed": failed, "iterations_mean": iters,
            **readings}


def control_reading(cell, sut, seed: int, device) -> dict:
    traffic = Traffic(cell.traffic, seed)
    count = int(cell.traffic["check"]["sweeps"])
    readings = sut.control(cell.config, traffic, traffic.check_sample(count), device, tf32)
    return {"seed": seed, "side": "control_tf32", **readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = spec.load(ROOT, args.workload)
    sut = spec.system(ROOT, cell.config["system"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = program_reading(cell, sut, seed, device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        out = control_reading(cell, sut, seed, device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
