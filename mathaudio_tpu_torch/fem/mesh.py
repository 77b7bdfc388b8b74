"""Host-side mesh container, the triangle and tetrahedron generators and
the icosphere surface (counterpart of mathaudio_tpu/fem/mesh.py; pure
numpy). The quadrilateral and hexahedral generators come with the rest of
slice 6c.

Boundary detection counts faces once (lexsort, no hash maps). Rectangle
tags: 1=x_min, 2=x_max, 3=y_min, 4=y_max; the box adds 5=z_min, 6=z_max;
the disk tags its rim 1; annulus and spherical shell: 1=inner, 2=outer.
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

    def boundary_nodes(self, tags=None) -> np.ndarray:
        """Unique node ids on boundary faces (optionally only given tags)."""
        if self.boundary_faces is None:
            raise ValueError("detect_boundaries() must run before boundary_nodes()")
        faces = self.boundary_faces
        if tags is not None:
            faces = faces[np.isin(self.boundary_markers, np.asarray(list(tags)))]
        return np.unique(faces)


def _tag_rectangle(mesh: Mesh, x_min, x_max, y_min, y_max, tol=1e-10):
    mesh.set_marker(1, lambda p: np.abs(p[:, 0] - x_min) < tol)
    mesh.set_marker(2, lambda p: np.abs(p[:, 0] - x_max) < tol)
    mesh.set_marker(3, lambda p: np.abs(p[:, 1] - y_min) < tol)
    mesh.set_marker(4, lambda p: np.abs(p[:, 1] - y_max) < tol)
    return mesh


def rectangular_mesh_triangles(x_min, x_max, y_min, y_max, nx, ny) -> Mesh:
    """2 triangles per cell, lexicographic nodes (x fastest), tags 1..4."""
    xs = np.linspace(x_min, x_max, nx + 1)
    ys = np.linspace(y_min, y_max, ny + 1)
    xx, yy = np.meshgrid(xs, ys, indexing="xy")
    nodes = np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1)

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    n00 = (j * (nx + 1) + i).reshape(-1)
    n10 = n00 + 1
    n01 = n00 + (nx + 1)
    n11 = n01 + 1
    t1 = np.stack([n00, n10, n11], axis=1)
    t2 = np.stack([n00, n11, n01], axis=1)
    elements = np.concatenate([t1, t2], axis=0)
    mesh = Mesh(2, nodes, elements.astype(np.int64), TRIANGLE).detect_boundaries()
    return _tag_rectangle(mesh, x_min, x_max, y_min, y_max)


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


def circular_mesh_triangles(radius: float, n_rings: int) -> Mesh:
    """Disk mesh: a centre fan and ring strips; the rim is tagged 1."""
    nodes = [np.zeros((1, 2))]
    ring_start = [0]
    for r in range(1, n_rings + 1):
        n_theta = 6 * r
        theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
        rr = radius * r / n_rings
        nodes.append(np.stack([rr * np.cos(theta), rr * np.sin(theta)], axis=1))
        ring_start.append(ring_start[-1] + len(nodes[-2]))
    nodes = np.concatenate(nodes, axis=0)
    elements = [[0, 1 + t, 1 + (t + 1) % 6] for t in range(6)]  # centre fan
    for r in range(1, n_rings):  # ring strips
        inner_n, outer_n = 6 * r, 6 * (r + 1)
        inner0, outer0 = ring_start[r], ring_start[r + 1]
        for t in range(outer_n):
            o1 = outer0 + t
            o2 = outer0 + (t + 1) % outer_n
            i1 = inner0 + int(np.floor(t * inner_n / outer_n)) % inner_n
            i2 = inner0 + int(np.ceil(t * inner_n / outer_n)) % inner_n
            elements.append([o1, o2, i1])
            if i1 != i2:
                elements.append([o2, i2, i1])
    mesh = Mesh(2, nodes, np.asarray(elements, np.int64), TRIANGLE).detect_boundaries()
    mesh.set_marker(1, lambda p: np.abs(np.linalg.norm(p, axis=1) - radius) < 1e-8 * max(radius, 1))
    return mesh


def annular_mesh_triangles(r_inner: float, r_outer: float, n_radial: int, n_theta: int) -> Mesh:
    """Annulus for 2D scattering: n_radial x n_theta cells of 2 triangles;
    tags 1=inner, 2=outer."""
    rs = np.linspace(r_inner, r_outer, n_radial + 1)
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
    rr, tt = np.meshgrid(rs, theta, indexing="ij")
    nodes = np.stack([(rr * np.cos(tt)).reshape(-1), (rr * np.sin(tt)).reshape(-1)], axis=1)
    ir, it = np.meshgrid(np.arange(n_radial), np.arange(n_theta), indexing="ij")
    a = ir * n_theta + it
    b = ir * n_theta + (it + 1) % n_theta
    c = (ir + 1) * n_theta + (it + 1) % n_theta
    d = (ir + 1) * n_theta + it
    # per cell [a, b, c] then [a, c, d], cells in (ir, it) order
    elements = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=2)
    mesh = Mesh(2, nodes, elements.reshape(-1, 3).astype(np.int64), TRIANGLE).detect_boundaries()
    tol = 1e-8 * max(r_outer, 1.0)
    mesh.set_marker(1, lambda p: np.abs(np.linalg.norm(p, axis=1) - r_inner) < tol)
    mesh.set_marker(2, lambda p: np.abs(np.linalg.norm(p, axis=1) - r_outer) < tol)
    return mesh


def spherical_shell_mesh_tetrahedra(r_inner: float, r_outer: float, n_radial: int,
                                    subdivisions: int = 2) -> Mesh:
    """Shell between two spheres for 3D scattering: radial layers of the
    icosphere surface, each prism between consecutive layers split into 3
    tets along the global vertex order (conforming faces, no polar
    degeneracy). Tags: 1=inner sphere, 2=outer sphere."""
    surf_v, surf_f = _icosphere_surface(subdivisions)
    nv = len(surf_v)
    rs = np.linspace(r_inner, r_outer, n_radial + 1)
    nodes = np.concatenate([r * surf_v for r in rs], axis=0)
    # each face's vertices sorted by global id: p0 < p1 < p2
    ordered = np.sort(surf_f, axis=1)
    elements = []
    for layer in range(n_radial):
        p0, p1, p2 = (layer * nv + ordered).T
        q0, q1, q2 = ((layer + 1) * nv + ordered).T
        prism = np.stack([np.stack([p0, p1, p2, q0], -1), np.stack([p1, p2, q0, q1], -1),
                          np.stack([p2, q0, q1, q2], -1)], axis=1)
        elements.append(prism.reshape(-1, 4))
    mesh = Mesh(3, nodes, np.concatenate(elements).astype(np.int64), TET).detect_boundaries()
    tol = 1e-8 * max(r_outer, 1.0)
    mesh.set_marker(1, lambda p: np.abs(np.linalg.norm(p, axis=1) - r_inner) < tol)
    mesh.set_marker(2, lambda p: np.abs(np.linalg.norm(p, axis=1) - r_outer) < tol)
    return mesh


def unit_square_triangles(n: int) -> Mesh:
    return rectangular_mesh_triangles(0.0, 1.0, 0.0, 1.0, n, n)


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
