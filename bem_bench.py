#!/usr/bin/env python3
"""Time the BEM pairwise kernel at every shape the BEM paths launch it.

    python3 bem_bench.py                  # this checkout's kernel, one GPU
    python3 bem_bench.py --repo DIR       # the kernel of another checkout

On the icosphere of the bench (4 subdivisions, N = 5120 elements, order-3
quadrature: nq = 4), float32 in and complex64 out, each variant is timed
at the shapes its paths launch: the dense-BEM sweep's band of 8
wavenumbers in [0.5, 3.0] (``double_layer`` rigid, ``burton_miller``
Burton–Miller), and the single-frequency paths' one wavenumber
(``burton_miller`` at ka = 2, the rigid sphere; ``mixed`` and ``mixed_bm``
at ka = 1 on the surface's own 5120 x 5120 pairs; ``kh`` and ``kh_double``
at the 8192 field points on r = 2, ``kh`` also at the cavity's 512 points
on r = 0.5). Slice 4c's shapes follow on the all-quad cube sphere
(cube_sphere(1.0, 29): N = 5046 bilinear quads, nq = 4): ``double_layer``
at ka = 1, ``burton_miller`` at ka = 2, ``kh_double`` at the 8192 field
points. So that a time can be told apart between the quads' data and their
row length, ``burton_miller`` at ka = 2 also runs on the icosphere's first
5046, 5048 and 5056 elements against themselves (rows of 5046, 5048 and 5056
outputs: only the last is a whole number of 128-byte lines per complex64
row). Each shape is timed two ways: ``stream_ms``, CUDA events
around 10 launches issued back to back from Python (what the paths see);
and ``graph_ms``, the same 10 launches captured once in a CUDA graph and
replayed (the card's time per launch, without the host). Each is the
median of 7 batches after a warm-up (chip_smoke.py's ``time_ms`` and
``graph_ms``).

To compare two versions, time them in turns on the same card (parent,
change, change, parent): ``--repo`` imports the package from DIR, which
builds its kernel from its own sources (and must have ``cube_sphere``).

    python3 bem_bench.py --sass           # machine-code counts

``--sass`` prints, per instantiation of the timed checkout's kernel, its
static SASS instructions and MUFU operations, and what its innermost loop
that holds MUFU.SIN runs per pass (less the slow paths a branch jumps
over: sqrtf's outside its fast range, the row walk's second pass over a
rare row) divided by the MUFU.SIN it runs: instructions per (i, j, q) of
the row walk (the row loop holds all nq points, with the row's own
instructions shared among them), per (i, j, q, k) of the band body's
quadrature loop.

Output: one JSON line {"repo": ..., "gpu": ..., "shapes": [...]} (with
``--sass`` also {"sass": [...]}).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

# the timers and the paths' shapes of this checkout, imported before --repo
# goes on the path
from chip_smoke import (BEM_BAND, BEM_FREQS, BEM_SUBDIV, CAVITY_SHAPE, FIELD_SHAPE, PATH3_KA,
                        PATH3_RIGID_KA, gpu_line, graph_ms, time_ms)

# (variant, surface, points, ks): the launches of the BEM paths; 8192 field
# points on r = 2, the cavity's 512 on r = 0.5; "quads" is phase 19's cube
# sphere, "ico:N" the icosphere's first N elements
SHAPES = (
    ("double_layer", "ico", "surface", "band"),
    ("burton_miller", "ico", "surface", "band"),
    ("burton_miller", "ico", "surface", (PATH3_RIGID_KA,)),
    ("mixed", "ico", "surface", (PATH3_KA,)),
    ("mixed_bm", "ico", "surface", (PATH3_KA,)),
    ("kh", "ico", "field", (PATH3_KA,)),
    ("kh", "ico", "cavity", (PATH3_KA,)),
    ("kh_double", "ico", "field", (PATH3_RIGID_KA,)),
    ("double_layer", "quads", "surface", (PATH3_KA,)),
    ("burton_miller", "quads", "surface", (PATH3_RIGID_KA,)),
    ("kh_double", "quads", "field", (PATH3_RIGID_KA,)),
    ("burton_miller", "ico:5046", "surface", (PATH3_RIGID_KA,)),
    ("burton_miller", "ico:5048", "surface", (PATH3_RIGID_KA,)),
    ("burton_miller", "ico:5056", "surface", (PATH3_RIGID_KA,)),
)
QUAD_N = 29  # chip_smoke.py's QUAD_N


FLAG_VARIANTS = {1: "double_layer", 5: "burton_miller", 3: "mixed", 15: "mixed_bm", 2: "kh",
                 0: "kh_double"}  # kernels/bem_pairwise.cu template FLAGS
KERNEL_NAME = re.compile(
    r"(bem_pairwise_rows_kernel|bem_pairwise_kernel)<(\w+), (\d+)(?:, (\d+))?>")


def sass_listing(kernels) -> dict:
    """The machine code of every kernel of the built kernels/bem_pairwise.cu
    of ``kernels`` (the kernel package of the checkout being timed), as
    ``cuobjdump -sass`` lists it: {demangled name: [(address, instruction),
    ...]}, NOPs left out."""
    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(kernels.build("bem_pairwise"))],
                          capture_output=True, text=True, check=True)
    out, current = {}, None
    for line in proc.stdout.splitlines():
        text = line.strip()
        if text.startswith("Function : "):
            symbol = text.split(":", 1)[1].strip()
            name = subprocess.run(["c++filt", symbol], capture_output=True, text=True).stdout
            current = out.setdefault(name.strip() or symbol, [])
        elif current is not None and text.startswith("/*") and "*/" in text:
            addr, rest = text[2:].split("*/", 1)
            instr = rest.split("/*")[0].strip().rstrip(";").strip()
            if instr and not instr.startswith("NOP"):
                current.append((int(addr, 16), instr))
    return out


def hot_loop(code):
    """The innermost loop that holds MUFU.SIN, less the code that a forward
    branch inside it jumps over where that code holds a CALL (sqrtf's slow
    path) or a MUFU.SIN (the row walk's second pass over a row with an r^2
    outside the fast path): {instructions, mufu, sin} of what runs per pass,
    or None (double: no MUFU.SIN)."""
    branches = [(addr, int(dst, 16)) for addr, ins in code
                for dst in re.findall(r"BRA (0x[0-9a-f]+)", ins)]
    for head, end in sorted(((dst, addr) for addr, dst in branches if dst < addr),
                            key=lambda loop: loop[1] - loop[0]):
        body = [(addr, ins) for addr, ins in code if head <= addr <= end]
        if not any("MUFU.SIN" in ins for _, ins in body):
            continue
        cold = set()
        for addr, dst in branches:
            if head <= addr < dst <= end and "@" in dict(code)[addr]:
                skipped = [(a, i) for a, i in body if addr < a < dst]
                if any("CALL" in i or "MUFU.SIN" in i for _, i in skipped):
                    cold.update(a for a, _ in skipped)
        hot = [ins for addr, ins in body if addr not in cold]
        sins = sum("MUFU.SIN" in ins for ins in hot)
        return dict(instructions=len(hot), mufu=sum("MUFU" in ins for ins in hot), sin=sins,
                    per_sin=round(len(hot) / sins, 2))
    return None


def sass_counts(kernels) -> list:
    """Per instantiation of kernels/bem_pairwise.cu: its body, variant,
    dtype, nq (row walk: 0 for any nq but 1 and 4), static instructions,
    MUFU operations, MUFU.RSQ, and its ``hot_loop``."""
    rows = []
    for name, code in sass_listing(kernels).items():
        m = KERNEL_NAME.search(name)
        if not m:
            continue
        walk = m.group(1) == "bem_pairwise_rows_kernel"
        flags = int(m.group(3))
        rows.append(dict(body="row walk" if walk else "band",
                         variant=FLAG_VARIANTS.get(flags, flags), dtype=m.group(2),
                         nq=int(m.group(4)) if walk else None,
                         instructions=len(code), mufu=sum("MUFU" in i for _, i in code),
                         rsq=sum("MUFU.RSQ" in i for _, i in code), loop=hot_loop(code)))
    return sorted(rows, key=lambda r: (r["body"], r["variant"], r["dtype"], r["nq"] or 0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent),
                    help="checkout whose mathaudio_tpu_torch package is timed")
    ap.add_argument("--sass", action="store_true",
                    help="print machine-code counts per instantiation, then time")
    args = ap.parse_args()
    repo = str(Path(args.repo).resolve())
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("bem_bench: no CUDA device is available", file=sys.stderr)
        return 1
    from mathaudio_tpu_torch.bem import sweep
    from mathaudio_tpu_torch.bem.mesh import cube_sphere, icosphere
    from mathaudio_tpu_torch.bem.postprocess import generate_sphere_eval_points
    from mathaudio_tpu_torch.ops import bem_assembly as ops

    if not ops.__file__.startswith(repo):
        raise AssertionError(f"imported {ops.__file__}, not the package under {repo}")
    if args.sass:
        from mathaudio_tpu_torch import kernels

        counts = sass_counts(kernels)  # the timed checkout's package builds its own source
        for row in counts:
            print(f"sass {row}", flush=True)
        print(json.dumps({"sass": counts}), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ico = sweep.sweep_statics(icosphere(1.0, BEM_SUBDIV), dtype=torch.float32, device=dev)
    statics = {"ico": ico, "quads": sweep.sweep_statics(cube_sphere(1.0, QUAD_N),
                                                        dtype=torch.float32, device=dev)}
    for name in {s[1] for s in SHAPES if s[1].startswith("ico:")}:
        n = int(name[4:])
        statics[name] = type(ico)(*(t[:n].contiguous() for t in ico))
    points = {}
    for name, (radius, shape) in (("field", (2.0, FIELD_SHAPE)), ("cavity", (0.5, CAVITY_SHAPE))):
        points[name] = torch.tensor(generate_sphere_eval_points(radius, *shape), dtype=torch.float32,
                                    device=dev)

    shapes = []
    for variant, surface, where, band in SHAPES:
        ks = (torch.linspace(*BEM_BAND, BEM_FREQS, dtype=torch.float32, device=dev) if band == "band"
              else torch.tensor(band, dtype=torch.float32, device=dev))
        st = statics[surface]
        x = st.centers if where == "surface" else points[where]
        nx = st.normals if where == "surface" else None

        def call():
            ops.bem_pairwise(variant, x, nx, st.qp, st.normals, st.qw, ks)

        stream_ms = time_ms(call)
        on_card = graph_ms(call)
        torch.cuda.empty_cache()
        shapes.append(dict(variant=variant, surface=surface, shape=f"{x.shape[0]}x{st.qp.shape[0]}",
                           nf=ks.shape[0], k=[round(float(v), 4) for v in ks[:1]],
                           stream_ms=stream_ms, graph_ms=on_card))
        print(f"{variant} {surface} {shapes[-1]['shape']} F={ks.shape[0]}: "
              f"stream {stream_ms:.4f} ms, graph {on_card:.4f} ms", flush=True)
    print(json.dumps({"repo": repo, "gpu": gpu_line(), "device": torch.cuda.get_device_name(0),
                      "shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
