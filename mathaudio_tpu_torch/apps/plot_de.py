"""Convergence plots for DE runs (counterpart of
mathaudio_tpu/apps/plot_de.py, host only;
math-differential-evolution/bin/plot_de.rs): reads the CSV traces
written by benchmark_convergence / the recorder and emits a
self-contained plotly HTML (CDN script, no plotting deps)."""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys


def _read_trace(path: str):
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        return None
    if "best" in rows[0]:
        xs = [int(r["iter"]) for r in rows]
        ys = [float(r["best"]) for r in rows]
    else:  # recorder format
        xs = [int(r["generation"]) for r in rows]
        ys = [float(r["best_so_far"]) for r in rows]
    return xs, ys


def plot_html(traces, title: str = "DE convergence") -> str:
    data = []
    for name, (xs, ys) in traces.items():
        data.append(
            {
                "type": "scatter",
                "mode": "lines",
                "name": name,
                "x": xs,
                "y": [max(y, 1e-300) for y in ys],
            }
        )
    layout = {
        "title": title,
        "xaxis": {"title": "generation"},
        "yaxis": {"title": "best f(x)", "type": "log"},
    }
    return f"""<!DOCTYPE html><html><head><title>{title}</title>
<script src="https://cdn.plot.ly/plotly-2.27.0.min.js"></script></head>
<body><div id="plot" style="height:600px"></div>
<script>Plotly.newPlot("plot", {json.dumps(data)}, {json.dumps(layout)});</script>
</body></html>
"""


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plot-de")
    ap.add_argument("traces", nargs="+", help="CSV trace files or globs")
    ap.add_argument("-o", "--output", default="de_convergence.html")
    ap.add_argument("--title", default="DE convergence")
    args = ap.parse_args(argv)

    traces = {}
    for pattern in args.traces:
        for path in sorted(glob.glob(pattern)) or [pattern]:
            t = _read_trace(path)
            if t:
                traces[os.path.splitext(os.path.basename(path))[0]] = t
    if not traces:
        print("no traces found", file=sys.stderr)
        return 1
    with open(args.output, "w") as fh:
        fh.write(plot_html(traces, args.title))
    print(f"wrote {args.output} ({len(traces)} traces)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
