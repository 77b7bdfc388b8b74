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
on r = 0.5). Each shape is timed two ways: ``stream_ms``, CUDA events
around 10 launches issued back to back from Python (what the paths see);
and ``graph_ms``, the same 10 launches captured once in a CUDA graph and
replayed (the card's time per launch, without the host). Each is the
median of 7 batches after a warm-up (chip_smoke.py's ``time_ms`` and
``graph_ms``).

To compare two versions, time them in turns on the same card (parent,
change, change, parent): ``--repo`` imports the package from DIR, which
builds its kernel from its own sources.

Output: one JSON line {"repo": ..., "gpu": ..., "shapes": [...]}.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# the timers and the paths' shapes of this checkout, imported before --repo
# goes on the path
from chip_smoke import (BEM_BAND, BEM_FREQS, BEM_SUBDIV, CAVITY_SHAPE, FIELD_SHAPE, PATH3_KA,
                        PATH3_RIGID_KA, gpu_line, graph_ms, time_ms)

# (variant, points, ks): the launches of the BEM paths; 8192 field points on
# r = 2, the cavity's 512 on r = 0.5
SHAPES = (
    ("double_layer", "surface", "band"),
    ("burton_miller", "surface", "band"),
    ("burton_miller", "surface", (PATH3_RIGID_KA,)),
    ("mixed", "surface", (PATH3_KA,)),
    ("mixed_bm", "surface", (PATH3_KA,)),
    ("kh", "field", (PATH3_KA,)),
    ("kh", "cavity", (PATH3_KA,)),
    ("kh_double", "field", (PATH3_RIGID_KA,)),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent),
                    help="checkout whose mathaudio_tpu_torch package is timed")
    repo = str(Path(ap.parse_args().repo).resolve())
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("bem_bench: no CUDA device is available", file=sys.stderr)
        return 1
    from mathaudio_tpu_torch.bem import sweep
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.bem.postprocess import generate_sphere_eval_points
    from mathaudio_tpu_torch.ops import bem_assembly as ops

    if not ops.__file__.startswith(repo):
        raise AssertionError(f"imported {ops.__file__}, not the package under {repo}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    st = sweep.sweep_statics(icosphere(1.0, BEM_SUBDIV), dtype=torch.float32, device=dev)
    points = {"surface": st.centers}
    for name, (radius, shape) in (("field", (2.0, FIELD_SHAPE)), ("cavity", (0.5, CAVITY_SHAPE))):
        points[name] = torch.tensor(generate_sphere_eval_points(radius, *shape), dtype=torch.float32,
                                    device=dev)

    shapes = []
    for variant, where, band in SHAPES:
        ks = (torch.linspace(*BEM_BAND, BEM_FREQS, dtype=torch.float32, device=dev) if band == "band"
              else torch.tensor(band, dtype=torch.float32, device=dev))
        x = points[where]
        nx = st.normals if where == "surface" else None

        def call():
            ops.bem_pairwise(variant, x, nx, st.qp, st.normals, st.qw, ks)

        stream_ms = time_ms(call)
        on_card = graph_ms(call)
        torch.cuda.empty_cache()
        shapes.append(dict(variant=variant, shape=f"{x.shape[0]}x{st.qp.shape[0]}",
                           nf=ks.shape[0], k=[round(float(v), 4) for v in ks[:1]],
                           stream_ms=stream_ms, graph_ms=on_card))
        print(f"{variant} {shapes[-1]['shape']} F={ks.shape[0]}: stream {stream_ms:.4f} ms, "
              f"graph {on_card:.4f} ms", flush=True)
    print(json.dumps({"repo": repo, "gpu": gpu_line(), "device": torch.cuda.get_device_name(0),
                      "shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
