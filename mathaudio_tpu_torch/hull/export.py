"""Hull exporters (counterpart of mathaudio_tpu/hull/export.py;
math-convex-hull/src/export.rs:12-54): OBJ + HTML. The OBJ header keeps
the JAX package's text, so both packages export the same strings."""

from __future__ import annotations

import json

from mathaudio_tpu_torch.hull.quickhull import ConvexHull3D


def hull_to_obj(hull: ConvexHull3D) -> str:
    """Wavefront OBJ text (export.rs:12)."""
    lines = ["# mathaudio_tpu convex hull"]
    remap = {int(v): i + 1 for i, v in enumerate(hull.vertices)}
    for v in hull.vertices:
        p = hull.points[v]
        lines.append(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}")
    for f in hull.faces:
        a, b, c = (remap[int(v)] for v in f.vertices)
        lines.append(f"f {a} {b} {c}")
    return "\n".join(lines) + "\n"


def hull_to_html(hull: ConvexHull3D, title: str = "Convex hull") -> str:
    """Self-contained plotly mesh3d HTML (export.rs:54)."""
    pts = hull.points
    data = {
        "type": "mesh3d",
        "x": pts[:, 0].tolist(),
        "y": pts[:, 1].tolist(),
        "z": pts[:, 2].tolist(),
        "i": [int(f.vertices[0]) for f in hull.faces],
        "j": [int(f.vertices[1]) for f in hull.faces],
        "k": [int(f.vertices[2]) for f in hull.faces],
        "opacity": 0.6,
    }
    return f"""<!DOCTYPE html><html><head><title>{title}</title>
<script src="https://cdn.plot.ly/plotly-2.27.0.min.js"></script></head>
<body><div id="plot"></div>
<script>Plotly.newPlot("plot", [{json.dumps(data)}], {{"title": "{title}"}});</script>
</body></html>
"""
