"""Host-side mesh container, the structured box generator and the
icosphere surface (counterpart of mathaudio_tpu/fem/mesh.py; pure numpy).

Boundary detection counts faces once (lexsort, no hash maps). Box tags:
1=x_min, 2=x_max, 3=y_min, 4=y_max, 5=z_min, 6=z_max.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

TRIANGLE = "triangle"
TET = "tet"

_FACES = {
    TRIANGLE: [[0, 1], [1, 2], [2, 0]],
    TET: [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]],
}


@dataclasses.dataclass
class Mesh:
    """nodes (N, dim) float64; elements (E, nv) int64; boundary faces +
    integer markers (0 = untagged)."""

    dim: int
    nodes: np.ndarray
    elements: np.ndarray
    element_type: str
    boundary_faces: Optional[np.ndarray] = None  # (F, fv) int64
    boundary_markers: Optional[np.ndarray] = None  # (F,) int64

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_elements(self) -> int:
        return self.elements.shape[0]

    def detect_boundaries(self) -> "Mesh":
        """Faces that belong to exactly one element are boundary faces."""
        face_local = np.asarray(_FACES[self.element_type])
        faces = self.elements[:, face_local]  # (E, nf, fv)
        faces = faces.reshape(-1, face_local.shape[1])
        key = np.sort(faces, axis=1)
        order = np.lexsort(key.T[::-1])
        key_sorted = key[order]
        first = np.ones(len(key_sorted), bool)
        first[1:] = (key_sorted[1:] != key_sorted[:-1]).any(axis=1)
        group = np.cumsum(first) - 1
        counts = np.bincount(group)
        boundary_groups = np.where(counts == 1)[0]
        sel = np.isin(group, boundary_groups)
        self.boundary_faces = faces[order][sel]
        self.boundary_markers = np.zeros(len(self.boundary_faces), np.int64)
        return self

    def set_marker(self, tag: int, predicate: Callable[[np.ndarray], np.ndarray]):
        """Tag boundary faces whose nodes all satisfy ``predicate``
        (node coords (M, dim) -> bool (M,))."""
        if self.boundary_faces is None:
            raise ValueError("detect_boundaries() must run before set_marker()")
        node_ok = predicate(self.nodes)
        face_ok = node_ok[self.boundary_faces].all(axis=1)
        self.boundary_markers[face_ok] = tag
        return self


def _box_nodes(x_min, x_max, y_min, y_max, z_min, z_max, nx, ny, nz):
    xs = np.linspace(x_min, x_max, nx + 1)
    ys = np.linspace(y_min, y_max, ny + 1)
    zs = np.linspace(z_min, z_max, nz + 1)
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    return np.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], axis=1)


def _box_corner_ids(nx, ny, nz):
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)

    def nid(ii, jj, kk):
        return kk * (ny + 1) * (nx + 1) + jj * (nx + 1) + ii

    return {
        "n000": nid(i, j, k),
        "n100": nid(i + 1, j, k),
        "n010": nid(i, j + 1, k),
        "n110": nid(i + 1, j + 1, k),
        "n001": nid(i, j, k + 1),
        "n101": nid(i + 1, j, k + 1),
        "n011": nid(i, j + 1, k + 1),
        "n111": nid(i + 1, j + 1, k + 1),
    }


def _tag_box(mesh, x_min, x_max, y_min, y_max, z_min, z_max, tol=1e-10):
    mesh.set_marker(1, lambda p: np.abs(p[:, 0] - x_min) < tol)
    mesh.set_marker(2, lambda p: np.abs(p[:, 0] - x_max) < tol)
    mesh.set_marker(3, lambda p: np.abs(p[:, 1] - y_min) < tol)
    mesh.set_marker(4, lambda p: np.abs(p[:, 1] - y_max) < tol)
    mesh.set_marker(5, lambda p: np.abs(p[:, 2] - z_min) < tol)
    mesh.set_marker(6, lambda p: np.abs(p[:, 2] - z_max) < tol)
    return mesh


def box_mesh_tetrahedra(x_min, x_max, y_min, y_max, z_min, z_max, nx, ny, nz) -> Mesh:
    """Kuhn triangulation, 6 tets per cube."""
    nodes = _box_nodes(x_min, x_max, y_min, y_max, z_min, z_max, nx, ny, nz)
    c = _box_corner_ids(nx, ny, nz)
    tets = [
        ("n000", "n100", "n110", "n111"),
        ("n000", "n110", "n010", "n111"),
        ("n000", "n010", "n011", "n111"),
        ("n000", "n011", "n001", "n111"),
        ("n000", "n001", "n101", "n111"),
        ("n000", "n101", "n100", "n111"),
    ]
    elements = np.concatenate(
        [np.stack([c[a], c[b], c[d], c[e]], axis=1) for a, b, d, e in tets], axis=0
    )
    mesh = Mesh(3, nodes, elements.astype(np.int64), TET).detect_boundaries()
    return _tag_box(mesh, x_min, x_max, y_min, y_max, z_min, z_max)


def unit_cube_tetrahedra(n: int) -> Mesh:
    return box_mesh_tetrahedra(0.0, 1.0, 0.0, 1.0, 0.0, 1.0, n, n, n)


def _icosphere_surface(subdivisions: int):
    """Icosphere vertices/faces on the unit sphere (shared with BEM)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        float,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces
