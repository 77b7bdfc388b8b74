"""Test-function surface plots (counterpart of
mathaudio_tpu/apps/plot_functions.py;
math-test-functions/bin/plot_functions.rs): 2D surface HTML via plotly
CDN for any registered function, plus per-function JSON metadata. The
grid is evaluated with ``torch.func.vmap`` in float64 on ``--device``
(the GPU by default).

A function defined only at other widths than 2 (``dimensions`` without 2:
colville, power_sum, powell, shekel, the Hartmann family) gets no surface,
as a 1-D one gets none. The JAX package evaluates those at 2-D points too:
there powell, shekel and the Hartmann family raise (``all`` stops at
hartman_3d), and colville reads its missing coordinates through JAX's
clamped indexing."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from mathaudio_tpu_torch.testfunctions import FUNCTIONS, get_function_metadata, list_functions
from mathaudio_tpu_torch.xtypes import resolve_device


def surface_html(name: str, resolution: int = 80, *, device=None) -> str:
    fn, meta = FUNCTIONS[name]
    (x0, x1), (y0, y1) = meta.bounds[0], meta.bounds[1]
    xs = np.linspace(x0, x1, resolution)
    ys = np.linspace(y0, y1, resolution)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = torch.as_tensor(np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1),
                          dtype=torch.float64, device=resolve_device(device))
    zz = torch.func.vmap(fn)(pts).cpu().numpy().reshape(resolution, resolution)
    data = [{
        "type": "surface",
        "x": xs.tolist(),
        "y": ys.tolist(),
        "z": zz.T.tolist(),
        "colorscale": "Viridis",
    }]
    for x_star, f_star in meta.global_minima:
        if len(x_star) >= 2:
            data.append({
                "type": "scatter3d", "mode": "markers",
                "x": [x_star[0]], "y": [x_star[1]], "z": [f_star],
                "marker": {"size": 6, "color": "red"},
                "name": "global minimum",
            })
    layout = {"title": name, "scene": {"zaxis": {"title": "f(x)"}}}
    return f"""<!DOCTYPE html><html><head><title>{name}</title>
<script src="https://cdn.plot.ly/plotly-2.27.0.min.js"></script></head>
<body><div id="plot" style="height:700px"></div>
<script>Plotly.newPlot("plot", {json.dumps(data)}, {json.dumps(layout)});</script>
</body></html>
"""


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plot-functions")
    ap.add_argument("functions", nargs="*", help="names (default: a showcase set)")
    ap.add_argument("-o", "--out-dir", default="function_plots")
    ap.add_argument("--resolution", type=int, default=80)
    ap.add_argument("--metadata", action="store_true", help="also write JSON metadata")
    ap.add_argument("--no-html", action="store_true",
                    help="metadata only (docs corpus generation)")
    ap.add_argument("--device", default=None,
                    help="torch device for the grids (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)

    if args.functions == ["all"]:
        names = list_functions()
    else:
        names = args.functions or [
            "rastrigin", "ackley", "rosenbrock", "himmelblau", "eggholder", "levy",
        ]
    os.makedirs(args.out_dir, exist_ok=True)

    for name in names:
        if name not in FUNCTIONS:
            print(f"unknown function {name}", file=sys.stderr)
            continue
        meta = get_function_metadata(name)
        if args.metadata:
            d = dataclasses.asdict(meta)
            d.pop("inequality_constraints", None)
            d.pop("equality_constraints", None)
            with open(os.path.join(args.out_dir, f"{name}.json"), "w") as fh:
                json.dump(d, fh, indent=2)
        if len(meta.bounds) < 2:
            print(f"skipping 1-D plot for {name}", file=sys.stderr)
            continue
        if meta.dimensions and 2 not in meta.dimensions:
            print(f"skipping {name}: defined only at widths {meta.dimensions}", file=sys.stderr)
            continue
        if not args.no_html:
            with open(os.path.join(args.out_dir, f"{name}.html"), "w") as fh:
                fh.write(surface_html(name, args.resolution, device=args.device))
            print(f"wrote {args.out_dir}/{name}.html", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
