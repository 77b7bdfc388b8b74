#!/usr/bin/env python3
"""Time the DIA stencil kernel at every shape the FEM bench sweep launches.

    python3 dia_bench.py                  # this checkout's kernel, one GPU
    python3 dia_bench.py --repo DIR       # the kernel of another checkout

For both smoothing levels of the bench hierarchy (9261 and 1331 nodes) at
the chunk's 2048 lanes and its 32 anchor lanes, complex64, each mode
(matvec, residual, jacobi, and jacobi from x = 0) is timed two ways:
``stream_ms``, CUDA events around 10 launches issued back to back from
Python (what the sweep sees: where the host issues slower than the card
runs, this is the host's time per launch); and ``graph_ms``, the same 10
launches captured once in a CUDA graph and replayed (the card's time per
launch, without the host). Each is the median of 7 batches after a warm-up
(chip_smoke.py's ``time_ms`` and ``graph_ms``).

To compare two versions, run them in turns in one session on one card
(parent, change, change, parent): ``--repo`` imports the package from DIR,
which builds its kernel from its own sources.

Output: one JSON line {"repo": ..., "gpu": ..., "shapes": [...]}.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# the timers of this checkout, imported before --repo goes on the path
from chip_smoke import gpu_line, graph_ms, time_ms

LEVELS = (20, 3)  # box mesh n and levels of the bench hierarchy
WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
LANES = (2048, 32)  # a chunk, and its anchors at warm stride 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent),
                    help="checkout whose mathaudio_tpu_torch package is timed")
    repo = str(Path(ap.parse_args().repo).resolve())
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("dia_bench: no CUDA device is available", file=sys.stderr)
        return 1
    from mathaudio_tpu_torch.fem import dia
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
    from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep

    if not dia.__file__.startswith(repo):
        raise AssertionError(f"imported {dia.__file__}, not the package under {repo}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    meshes = box_hierarchy(*LEVELS)
    mg = GeometricMultigrid(meshes, robin_tags=WALLS, dtype=torch.float32, device=dev)
    params = NodeMajorRoomSweep(RoomSweepModel(meshes[0], assembler=mg.assemblers[0], **ROOM),
                                mg).params()
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand(shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))

    shapes = []
    for level, offs, tabs in ((0, params.offsets[0], params.fine_tables),
                              (1, params.offsets[1], params.levels[1].tables)):
        n = tabs.k.shape[1]
        for nf in LANES:
            k = torch.linspace(0.55, 2.2, nf, device=dev).to(torch.complex64)
            cm = ((1.0 + 0.5j if level else 1.0) * k * k).contiguous()
            cb = (-0.15j * k).contiguous()
            x, r = rand((n, nf)), rand((n, nf))
            for mode, x_in in (("matvec", x), ("residual", x), ("jacobi", x), ("jacobi", None)):
                r_in = None if mode == "matvec" else r

                def call():
                    dia.dia_stencil(mode, offs, tabs, cm, cb, x_in, r_in, 1.0)

                stream_ms = time_ms(call)
                on_card = graph_ms(call)
                shapes.append(dict(mode=mode + ("(x=0)" if x_in is None else ""),
                                   shape=f"{n}x{nf}", stream_ms=stream_ms, graph_ms=on_card))
                print(f"{n} x {nf} {shapes[-1]['mode']}: stream {stream_ms:.4f} ms, graph "
                      f"{on_card:.4f} ms", flush=True)
    print(json.dumps({"repo": repo, "gpu": gpu_line(), "shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
