#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one GPU

The main path is the node-major FEM Helmholtz room sweep at the bench
shape: a P1 box mesh at n=20 (9261 nodes) in a 3-level hierarchy, 4096
wavenumbers in [0.55, 2.2] streamed as two chunks of 2048, shifted-
Laplacian V(1,1) Jacobi multigrid (omega 1) preconditioning restarted
GMRES (CGS1, restart 6, tol 1e-5), 16 Newton-Schulz-chained coarse
inverses per band solve, anchor warm starts (stride 64, cubic, restart 3).

Phases, each fatal on failure:
1. build the hand-written DIA stencil kernel (kernels/dia_stencil.cu);
2. hold each kernel mode against its plain PyTorch twin on the card at the
   bench shape (complex64, rel. error <= 1e-5), at an odd lane count, and
   in complex128 at a small shape (<= 1e-12), and time kernel and twin;
3. run the sweep with every launch count set to 0 just before and read
   just after: every kernel must have launched, 4096/4096 lanes must
   converge; then time repeats;
4. check the answers: a 256-lane sub-band with the kernels vs with the
   twins on the card, and a small float64 sweep on the card vs on the CPU.
With ``--profile``, one more bench sweep runs under torch.profiler after
phase 3 and its device time is printed by kernel group and kernel, with
the device's idle share of the wall time.

Output: progress lines, then one ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``. Exits non-zero with no result line when
no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the
# non-tensor-core rates of the kernel's arithmetic type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"complex64": 67e12, "complex128": 34e12}

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
BENCH_N, BENCH_LEVELS, BENCH_FREQS, BENCH_CHUNK = 20, 3, 4096, 2048
SWEEP_KNOBS = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=16, gmres_orth="cgs1",
                   freq_chunk=BENCH_CHUNK, warm_stride=64, warm_restart=3,
                   warm_interp="cubic")
KERNEL_SOURCE = "mathaudio_tpu_torch/kernels/dia_stencil.cu"
TPU_KERNEL = "mathaudio_tpu/fem/dia.py:212"
MODES = ("matvec", "residual", "jacobi")
FLOPS_PER_PAIR = 15  # per in-band (node, diagonal) and lane: coefficient 7, complex FMA 8
EPILOGUE_FLOPS = {"matvec": 0, "residual": 2, "jacobi": 31}  # per output


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def stencil_work(mode, n, nf, offsets, cdtype, from_zero=False):
    """(bytes, flops) one call must move and do: each input read once, the
    output written once; flops over the in-band (node, diagonal) pairs."""
    import torch

    cb = torch.empty((), dtype=cdtype).element_size()
    rb = cb // 2
    vec = n * nf * cb
    n_vec = {"matvec": 2, "residual": 3, "jacobi": 2 if from_zero else 3}[mode]
    tables = 0 if from_zero else 3 * len(offsets) * n * rb
    diag_tables = 3 * n * rb if mode == "jacobi" else 0
    pairs = 0 if from_zero else sum(max(n - abs(o), 0) for o in offsets)
    nbytes = n_vec * vec + tables + diag_tables + 2 * nf * cb
    flops = FLOPS_PER_PAIR * pairs * nf + EPILOGUE_FLOPS[mode] * n * nf
    return nbytes, flops


def bound(mode, n, nf, offsets, cdtype, from_zero=False):
    """(least time in ms, "bytes" | "operations") for one call."""
    nbytes, flops = stencil_work(mode, n, nf, offsets, cdtype, from_zero)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(cdtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, batches=7, per_batch=10):
    """Median over batches of the mean time per call, CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / per_batch)
    return statistics.median(samples)


def kernel_phase(dia, nm, dev, dtype_small_nm, ks_all):
    """Each mode vs its twin at the bench shapes; returns per-mode records
    at the fine level (the shape the GMRES operator and level-0 smoother
    see)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand(shape, cdtype):
        rdt = torch.float32 if cdtype == torch.complex64 else torch.float64
        re = torch.randn(shape, generator=gen, device=dev, dtype=rdt)
        im = torch.randn(shape, generator=gen, device=dev, dtype=rdt)
        return torch.complex(re, im)

    def lanes(ks, shifted, cdtype):
        k = ks.to(cdtype)
        cm = (torch.tensor(1.0 + 0.5j, dtype=cdtype, device=dev) if shifted else 1.0) * (k * k)
        cb = torch.tensor(-0.15j, dtype=cdtype, device=dev) * k
        return cm.contiguous(), cb.contiguous()

    twin = twin_stencil(dia)

    def run(mode, offs, tabs, cm, cb, x, r, kernel):
        return (dia.dia_stencil if kernel else twin)(mode, offs, tabs, cm, cb, x, r, 1.0)

    def check(label, mode, offs, tabs, cm, cb, x, r, tol):
        got = run(mode, offs, tabs, cm, cb, x, r, True)
        ref = run(mode, offs, tabs, cm, cb, x, r, False)
        torch.cuda.synchronize()
        rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
        max_abs = float(torch.max(torch.abs(got - ref)))
        ok = rel <= tol and bool(torch.isfinite(got).all())
        log(f"kernel {label} {mode}{'(x=0)' if x is None else ''}: "
            f"rel err {rel:.3e} (tol {tol:g}), max abs err {max_abs:.3e}")
        if not ok:
            raise AssertionError(f"{label} {mode}: kernel disagrees with its twin ({rel:.3e})")
        return max_abs

    params = nm.params()
    ks = ks_all[:BENCH_CHUNK]
    records = {}
    shapes = [("fine", params.offsets[0], params.fine_tables, False),
              ("level1", params.offsets[1], params.levels[1].tables, True)]
    for label, offs, tabs, shifted in shapes:
        n, nf = tabs.k.shape[1], ks.shape[0]
        cm, cb = lanes(ks, shifted, torch.complex64)
        x, r = rand((n, nf), torch.complex64), rand((n, nf), torch.complex64)
        for mode in MODES:
            max_abs = check(f"c64 {label} N={n} F={nf}", mode, offs, tabs, cm, cb, x,
                            None if mode == "matvec" else r, 1e-5)
            ms = time_ms(lambda: run(mode, offs, tabs, cm, cb, x, r, True))
            plain_ms = time_ms(lambda: run(mode, offs, tabs, cm, cb, x, r, False), batches=3,
                               per_batch=3)
            b_ms, b_by = bound(mode, n, nf, offs, torch.complex64)
            log(f"  {label} {mode}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound")
            if label == "fine":
                records[mode] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                     bound_ms=b_ms, bound_by=b_by)
        check(f"c64 {label} N={n} F={nf}", "jacobi", offs, tabs, cm, cb, None, r, 1e-5)
        ms0 = time_ms(lambda: run("jacobi", offs, tabs, cm, cb, None, r, True))
        b0, _ = bound("jacobi", n, nf, offs, torch.complex64, from_zero=True)
        log(f"  {label} jacobi(x=0): kernel {ms0:.4f} ms, bound {b0:.4f} ms (bytes)")

    # odd lane count: partial warps and partial blocks
    offs, tabs = params.offsets[0], params.fine_tables
    n = tabs.k.shape[1]
    cm, cb = lanes(ks[:37], False, torch.complex64)
    x, r = rand((n, 37), torch.complex64), rand((n, 37), torch.complex64)
    for mode in MODES:
        check(f"c64 fine N={n} F=37", mode, offs, tabs, cm, cb, x, r, 1e-5)

    # complex128 at a small shape
    p64 = dtype_small_nm.params()
    for label, offs, tabs, shifted in [("fine", p64.offsets[0], p64.fine_tables, False),
                                       ("level1", p64.offsets[1], p64.levels[1].tables, True)]:
        n = tabs.k.shape[1]
        cm, cb = lanes(torch.linspace(0.55, 2.2, 64, dtype=torch.float64, device=dev),
                       shifted, torch.complex128)
        x, r = rand((n, 64), torch.complex128), rand((n, 64), torch.complex128)
        for mode in MODES:
            check(f"c128 {label} N={n} F=64", mode, offs, tabs, cm, cb, x, r, 1e-12)
        check(f"c128 {label} N={n} F=64", "jacobi", offs, tabs, cm, cb, None, r, 1e-12)
    return records


def twin_stencil(dia):
    """A stand-in for dia.dia_stencil that runs the plain twins (on the
    card), to compare whole sweeps with and without the kernel."""

    def stencil(mode, offsets, tables, cm, cb, x, r=None, omega=1.0):
        if mode == "matvec":
            return dia.dia_matvec_ref(offsets, tables, cm, cb, x)
        if mode == "residual":
            return dia.dia_residual_ref(offsets, tables, cm, cb, x, r)
        return dia.dia_jacobi_ref(offsets, tables, cm, cb, x, r, omega)

    return stencil


def _kernel_group(name: str) -> str:
    low = name.lower()
    for key, group in (("dia_stencil", "dia_stencil (hand-written)"), ("gemm", "gemm"),
                       ("gemv", "gemm"), ("xmma", "gemm"), ("getrf", "lu/inverse"),
                       ("getri", "lu/inverse"), ("trsm", "lu/inverse"), ("index", "gather/index"),
                       ("gather", "gather/index"), ("reduce", "reduction"), ("cat", "copy/cat"),
                       ("copy", "copy/cat"), ("fill", "fill")):
        if key in low:
            return group
    return "elementwise/other"


def profile_sweep(sweep, params, ks):
    """One sweep under torch.profiler: device time by kernel group and by
    kernel, and the device's idle share of the sweep's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(params, ks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    by_group, by_name = {}, {}
    for start, end, name in spans:
        us = end - start
        g = _kernel_group(name)
        by_group[g] = by_group.get(g, 0.0) + us
        count, total = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, total + us)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for start, end, _ in spans:
        if cur_e is None or start > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    window_ms = (spans[-1][1] - spans[0][0]) / 1e3
    log(f"profile: wall {wall_ms:.1f} ms (profiled), device window {window_ms:.1f} ms, "
        f"device busy {busy / 1e3:.1f} ms, idle share of wall {100 * (1 - busy / 1e3 / wall_ms):.1f}%, "
        f"{len(spans)} device activities")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"profile group: {g}: {us / 1e3:.2f} ms ({100 * us / busy:.1f}% of busy)")
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"profile kernel: {us / 1e3:.2f} ms in {count} calls: {name[:110]}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bench sweep (torch.profiler) and print "
                         "device time by kernel and the device's idle share")
    profile = ap.parse_args().profile
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from mathaudio_tpu_torch import kernels
    from mathaudio_tpu_torch.fem import dia
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
    from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"gpu: {gpu_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 1. build
    t0 = time.perf_counter()
    fresh = not kernels.library_path("dia_stencil").exists()
    kernels.load("dia_stencil")
    log(f"build: dia_stencil.cu -> {kernels.library_path('dia_stencil').name} "
        f"{'built' if fresh else 'cached'} in {time.perf_counter() - t0:.2f} s")

    # host build at the bench shape (float32) and a small float64 one
    t0 = time.perf_counter()
    meshes = box_hierarchy(BENCH_N, BENCH_LEVELS)
    mg = GeometricMultigrid(meshes, robin_tags=WALLS, dtype=torch.float32, device=dev)
    nm = NodeMajorRoomSweep(RoomSweepModel(meshes[0], assembler=mg.assemblers[0], **ROOM), mg)
    torch.cuda.synchronize()
    log(f"host build n={BENCH_N}: {meshes[0].num_nodes} nodes, {meshes[0].num_elements} tets, "
        f"levels {[m.num_nodes for m in meshes]}, {time.perf_counter() - t0:.2f} s")
    small = {}
    for where in (dev, torch.device("cpu")):
        sm = box_hierarchy(8, 3)
        smg = GeometricMultigrid(sm, robin_tags=WALLS, dtype=torch.float64, device=where)
        small[where.type] = NodeMajorRoomSweep(
            RoomSweepModel(sm[0], assembler=smg.assemblers[0], **ROOM), smg)
    ks = torch.linspace(0.55, 2.2, BENCH_FREQS, dtype=torch.float32, device=dev)

    # 2. kernels vs twins
    records = kernel_phase(dia, nm, dev, small["cuda"], ks)

    # 3. the main path, counted
    config = KrylovConfig(max_iterations=500, tolerance=1e-5, restart=6)
    sweep = nm.sweep_fn(config, **SWEEP_KNOBS)
    params = nm.params()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dia.reset_launches()
    t0 = time.perf_counter()
    p, its, conv = sweep(params, ks)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(dia.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    n_conv = int(conv.sum())
    its_f = its.float()
    log(f"sweep {BENCH_FREQS} x {meshes[0].num_nodes}: first run {t_first:.3f} s, "
        f"converged {n_conv}/{BENCH_FREQS}, iterations mean {float(its_f.mean()):.3f} "
        f"max {int(its.max())}, peak memory {peak_gib:.2f} GiB, launches {launches}")
    if any(launches[m] == 0 for m in MODES):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    if n_conv != BENCH_FREQS:
        raise AssertionError(f"only {n_conv}/{BENCH_FREQS} frequencies converged")
    if tuple(p.shape) != (BENCH_FREQS, 2) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"bad pressure output: shape {tuple(p.shape)}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p2, its2, _ = sweep(params, ks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_sweep = statistics.median(times)
    if not torch.equal(its2, its):
        raise AssertionError("repeat sweep changed the iteration counts")
    log(f"sweep steady state: median {t_sweep * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} ms, "
        f"{meshes[0].num_nodes * BENCH_FREQS / t_sweep:.4e} DoF-solves/s")
    if profile:
        profile_sweep(sweep, params, ks)

    # 4a. 256-lane sub-band: kernels vs twins on the card
    sub = ks[:256].contiguous()
    p_k, its_k, conv_k = sweep(params, sub)
    kernel_stencil = dia.dia_stencil
    dia.dia_stencil = twin_stencil(dia)
    try:
        p_t, its_t, conv_t = sweep(params, sub)
    finally:
        dia.dia_stencil = kernel_stencil
    torch.cuda.synchronize()
    p_err = float(torch.max(torch.abs(p_k - p_t)) / torch.max(torch.abs(p_t)))
    it_diff = int(torch.max(torch.abs(its_k - its_t)))
    log(f"sub-band 256 kernel vs twins: pressure max err {p_err:.3e} of max|p|, "
        f"iteration diff max {it_diff}, converged {int(conv_k.sum())}/{int(conv_t.sum())}")
    if p_err > 1e-3 or it_diff > 1 or not (bool(conv_k.all()) and bool(conv_t.all())):
        raise AssertionError("sweep with kernels disagrees with the sweep with twins")

    # 4b. small float64 sweep: card (complex128 kernel) vs CPU (twins)
    small_cfg = KrylovConfig(max_iterations=500, tolerance=1e-5, restart=6)
    small_knobs = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=4, gmres_orth="cgs1",
                       freq_chunk=16, warm_stride=4, warm_restart=3, warm_interp="cubic")
    ks_small = torch.linspace(0.55, 2.2, 32, dtype=torch.float64)
    out = {}
    for where, snm in small.items():
        out[where] = snm.sweep_fn(small_cfg, **small_knobs)(snm.params(), ks_small)
    (pg, ig, cg), (pc, ic, cc) = ((t.cpu() for t in out[w]) for w in ("cuda", "cpu"))
    s_err = float(torch.max(torch.abs(pg - pc)) / torch.max(torch.abs(pc)))
    log(f"small f64 sweep card vs CPU: pressure max err {s_err:.3e}, "
        f"iterations equal {bool(torch.equal(ig, ic))}, converged {int(cg.sum())}/{int(cc.sum())}")
    if s_err > 1e-9 or not torch.equal(ig, ic) or not bool(cg.all()):
        raise AssertionError("float64 sweep on the card disagrees with the CPU")

    kernels_line = {"kernels": [
        dict(name=f"dia_stencil_{mode}", route="cuda", source=KERNEL_SOURCE, replaces=TPU_KERNEL,
             launches=launches[mode], library_ms=None, **records[mode])
        for mode in MODES
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
