"""3D Quickhull (counterpart of mathaudio_tpu/hull/quickhull.py;
math-convex-hull/src/quickhull.rs:168, types.rs:9-182, lib.rs:56-100:
scale-aware epsilon + vertex dedup). Host numpy: faces come out in the
JAX package's order."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Face:
    """Triangle face: vertex indices + outward normal + plane offset."""

    vertices: Tuple[int, int, int]
    normal: np.ndarray
    offset: float


@dataclasses.dataclass
class ConvexHull3D:
    points: np.ndarray  # input points (deduped)
    vertices: np.ndarray  # indices of hull vertices
    faces: List[Face]

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    def volume(self) -> float:
        c = self.points[self.vertices].mean(axis=0)
        vol = 0.0
        for f in self.faces:
            a, b, d = (self.points[v] - c for v in f.vertices)
            vol += abs(np.dot(np.cross(a, b), d)) / 6.0
        return vol

    def surface_area(self) -> float:
        area = 0.0
        for f in self.faces:
            a = self.points[f.vertices[1]] - self.points[f.vertices[0]]
            b = self.points[f.vertices[2]] - self.points[f.vertices[0]]
            area += 0.5 * np.linalg.norm(np.cross(a, b))
        return area

    def contains(self, p, tol: float = 1e-9) -> bool:
        p = np.asarray(p, float)
        return all(np.dot(f.normal, p) <= f.offset + tol for f in self.faces)


def _dedup(points: np.ndarray, eps: float):
    key = np.round(points / max(eps, 1e-300)).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return points[np.sort(idx)]


def quickhull_3d(points, eps: Optional[float] = None) -> ConvexHull3D:
    """Quickhull with scale-aware epsilon (quickhull.rs:168)."""
    pts = np.asarray(points, float)
    assert pts.ndim == 2 and pts.shape[1] == 3
    scale = float(np.abs(pts).max()) or 1.0
    if eps is None:
        eps = 1e-12 * scale
    pts = _dedup(pts, eps)
    n = len(pts)
    if n < 4:
        raise ValueError("need at least 4 non-duplicate points")

    # initial simplex: extremes along x, then farthest point / plane
    i0 = int(np.argmin(pts[:, 0]))
    i1 = int(np.argmax(pts[:, 0]))
    if i0 == i1:
        raise ValueError("degenerate input (all x equal)")
    d = pts - pts[i0]
    line = pts[i1] - pts[i0]
    cross = np.cross(d, line)
    i2 = int(np.argmax(np.einsum("nd,nd->n", cross, cross)))
    normal = np.cross(pts[i1] - pts[i0], pts[i2] - pts[i0])
    if np.linalg.norm(normal) < eps:
        raise ValueError("degenerate input (collinear points)")
    dist = np.abs((pts - pts[i0]) @ normal)
    i3 = int(np.argmax(dist))
    if dist[i3] < eps:
        raise ValueError("degenerate input (coplanar points)")

    centroid = pts[[i0, i1, i2, i3]].mean(axis=0)

    def make_face(a, b, c):
        nrm = np.cross(pts[b] - pts[a], pts[c] - pts[a])
        ln = np.linalg.norm(nrm)
        nrm = nrm / ln
        off = float(nrm @ pts[a])
        if nrm @ centroid > off:  # orient outward
            b, c = c, b
            nrm = -nrm
            off = float(nrm @ pts[a])
        return Face((a, b, c), nrm, off)

    faces = [
        make_face(i0, i1, i2),
        make_face(i0, i1, i3),
        make_face(i0, i2, i3),
        make_face(i1, i2, i3),
    ]

    # outside sets
    def outside_set(face, candidates):
        d = pts[candidates] @ face.normal - face.offset
        mask = d > eps
        return candidates[mask], d[mask]

    all_idx = np.arange(n)
    pending = []  # (face, outside candidate indices)
    assigned = np.zeros(n, bool)
    assigned[[i0, i1, i2, i3]] = True
    rest = all_idx[~assigned]
    for f in faces:
        out, dd = outside_set(f, rest)
        pending.append([f, out])

    final_faces: List[Face] = []
    while pending:
        face, out = pending.pop()
        if len(out) == 0:
            final_faces.append(face)
            continue
        d = pts[out] @ face.normal - face.offset
        apex = int(out[np.argmax(d)])

        # find all faces (pending + final) visible from apex
        visible = []
        still_pending = []
        for f, o in pending:
            if f.normal @ pts[apex] > f.offset + eps:
                visible.append((f, o))
            else:
                still_pending.append([f, o])
        keep_final = []
        for f in final_faces:
            if f.normal @ pts[apex] > f.offset + eps:
                visible.append((f, np.empty(0, np.int64)))
            else:
                keep_final.append(f)
        final_faces = keep_final
        visible.append((face, out))
        pending = still_pending

        # horizon edges: edges of visible faces shared by exactly one
        edge_count = {}
        for f, _ in visible:
            vs = f.vertices
            for e in [(vs[0], vs[1]), (vs[1], vs[2]), (vs[2], vs[0])]:
                key = (min(e), max(e))
                edge_count.setdefault(key, []).append(e)
        horizon = [v[0] for v in edge_count.values() if len(v) == 1]

        # candidate points = union of visible faces' outside sets minus apex
        cand = np.unique(np.concatenate([o for _, o in visible]))
        cand = cand[cand != apex]

        for a, b in horizon:
            nf = make_face(a, b, apex)
            out_new, _ = outside_set(nf, cand)
            pending.append([nf, out_new])

    verts = np.unique(np.concatenate([np.asarray(f.vertices) for f in final_faces]))
    return ConvexHull3D(pts, verts, final_faces)


def convex_hull_3d(points, eps: Optional[float] = None) -> ConvexHull3D:
    """Alias matching the reference's top-level API (lib.rs)."""
    return quickhull_3d(points, eps)
