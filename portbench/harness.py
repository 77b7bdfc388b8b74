"""One run of one cell: build the program, warm up the cell's shapes,
measure a closed loop of sweeps for the window, optionally trace a few
more sweeps, check a sample of the window's answers against the plain
reference, and reduce everything to the cell's metrics.

A sweep's time runs from its call to its answers on the host. The
window ends with the first sweep that finishes after ``seconds``; rates
are taken over every sweep of the window and the whole window.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from portbench import spec
from portbench.timeline import breakdown, union_us
from portbench.traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "mathaudio_tpu")
SWEEP_SPAN = "portbench.sweep"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def process_start_s() -> float:
    """Seconds since this process started."""
    import os

    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(system, traffic, seconds: float):
    """The closed loop: (per-sweep records, outputs by sweep index, window seconds)."""
    sweeps, outputs = [], {}
    start = time.perf_counter()
    i = 0
    while True:
        inputs = traffic.sweep(i)
        t0 = time.perf_counter()
        out = system.run(inputs)
        t1 = time.perf_counter()
        rec = system.summary(out)
        rec["wall_s"] = t1 - t0
        sweeps.append(rec)
        outputs[i] = out
        i += 1
        if t1 - start >= seconds:
            return sweeps, outputs, t1 - start


def traced(system, traffic, count: int, device) -> dict:
    """``count`` more sweeps under the profiler (after one warm step that
    the profiler discards), reduced to device spans, host operations, the
    traced window and the program's counters over those sweeps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    first = 1 << 30  # sweep indices of the traced sweeps, apart from the window's
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        system.run(traffic.sweep(first))
        sync(device)
        prof.step()
        system.reset_counters()
        for j in range(count):
            with record_function(SWEEP_SPAN):
                system.run(traffic.sweep(first + 1 + j))
        sync(device)
        counters = system.counters()
        prof.step()
    kernels, cpu_ops, spans = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        # the spans' own annotations on the device timeline are no device work
        marker = e.name == SWEEP_SPAN or e.name.startswith("ProfilerStep")
        if e.device_type == DeviceType.CUDA:
            if not marker and not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, start, end))
        elif e.name == SWEEP_SPAN:
            spans.append((start, end))
        elif not marker:
            cpu_ops.append((e.name, start, end))
    if not kernels or len(spans) != count:
        raise RuntimeError(f"the trace holds {len(kernels)} device operations and "
                           f"{len(spans)} of {count} sweep spans")
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    busy = union_us([(s, e) for _, s, e in kernels], lo, hi)
    return {"kernels": kernels, "sweeps": count, "window_s": (hi - lo) / 1e6,
            "busy_s": busy / 1e6, "counters": counters,
            "breakdown": breakdown(kernels, cpu_ops, lo, hi, skip=(SWEEP_SPAN,))}


def run(root, name: str, seed: int, seconds: float, trace: bool, device,
        t_start=None, log=print) -> dict:
    """One run; returns the result line as a dict. ``t_start``: the
    ``time.perf_counter()`` reading at which set-up began (default now)."""
    t_enter = time.perf_counter() if t_start is None else t_start
    cell = spec.load(root, name)
    sut = spec.system(root, cell.config["system"])
    traffic = Traffic(cell.traffic, seed)
    system = sut.System(cell.config, traffic, device)
    for j in range(int(cell.traffic["warm_sweeps"])):
        system.run(traffic.warm(j))
    sync(device)
    setup_s = time.perf_counter() - t_enter

    sweeps, outputs, window_s = window(system, traffic, seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package are loaded: {found}")
    record = {"workload": name, "config": cell.config, "traffic": cell.traffic,
              "setup_s": setup_s, "host_build_s": system.host_build_s, "window_s": window_s,
              "sweeps": sweeps, "trace": None}
    if trace:
        record["trace"] = traced(system, traffic, int(cell.traffic["trace_sweeps"]), device)
        peak = max(peak, torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)

    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = traffic.check_sample(len(sweeps))
    readings = sut.check(cell.config, traffic, outputs, sample, device)
    failed = sum(s["failed"] for s in sweeps)
    limits = cell.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": sum(s["lanes"] for s in sweeps),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = record["trace"]["breakdown"]
    result["checks"] = checks
    log(f"window: {len(sweeps)} sweeps in {window_s:.3f} s, median sweep "
        f"{statistics.median(s['wall_s'] for s in sweeps) * 1e3:.2f} ms, set-up {setup_s:.2f} s")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return result
