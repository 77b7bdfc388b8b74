"""Surface meshes for BEM (counterpart of mathaudio_tpu/bem/mesh.py; pure
numpy). Constant triangular or bilinear quadrilateral elements,
struct-of-arrays layout: everything the kernels need (centers, normals,
areas, quadrature points) is precomputed into flat arrays that the solvers
move to the device once. Generators: the icosphere, the latitude-longitude
sphere, the open or closed cylinder and the all-quad cube sphere.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mathaudio_tpu_torch.fem.basis import shape_functions
from mathaudio_tpu_torch.fem.mesh import QUAD, _icosphere_surface
from mathaudio_tpu_torch.fem.quadrature import quad_rule, triangle_rule


@dataclasses.dataclass
class SurfaceMesh:
    """Closed surface of constant triangular (N, 3) or quadrilateral
    (N, 4) elements; normals point away from the body (into the exterior
    acoustic domain)."""

    nodes: np.ndarray  # (Nn, 3)
    elements: np.ndarray  # (N, 3) or (N, 4) int

    def __post_init__(self):
        pts = self.nodes[self.elements]
        if self.elements.shape[1] == 3:
            v1 = pts[:, 1] - pts[:, 0]
            v2 = pts[:, 2] - pts[:, 0]
            cr = np.cross(v1, v2)
            nrm = np.linalg.norm(cr, axis=1)
            self.areas = 0.5 * nrm
            self.normals = cr / np.maximum(nrm, 1e-300)[:, None]
        else:  # quad: normal from the diagonals, area from the two tris
            d1 = pts[:, 2] - pts[:, 0]
            d2 = pts[:, 3] - pts[:, 1]
            cr = np.cross(d1, d2)
            nrm = np.linalg.norm(cr, axis=1)
            self.normals = cr / np.maximum(nrm, 1e-300)[:, None]
            # bilinear-patch area via the tensor-Gauss Jacobian (exact for
            # the patch; the two-triangle split differs for warped quads)
            ref_pts, ref_w = quad_rule(2)
            self.areas = _bilinear_jacobian(pts, ref_pts) @ ref_w
        self.centers = pts.mean(axis=1)

    @property
    def nodes_per_element(self) -> int:
        return self.elements.shape[1]

    @property
    def num_elements(self) -> int:
        return len(self.elements)

    def avg_element_size(self) -> float:
        return float(np.sqrt(self.areas.mean()))

    def ka_radius(self) -> float:
        """Effective acoustic radius for ka-based rules (Burton–Miller
        beta-scale selection): mean element-center distance from the
        centroid."""
        c = self.centers - self.centers.mean(axis=0)
        return float(np.linalg.norm(c, axis=1).mean())

    def quad_points_refined(self, order: int = 3, depth: int = 2):
        """Subdivided quadrature: each (flat) triangle split into
        4**depth midpoint children, the order-``order`` rule on each (the
        static-shape form of a distance-adaptive order upgrade for
        quasi-singular pairs). Returns (points (N, nq*4**depth, 3),
        weights (N, nq*4**depth))."""
        if self.nodes_per_element != 3:
            raise ValueError("the refined rule takes triangles only")
        tris = self.nodes[self.elements][:, None, :, :]  # (N, 1, 3, 3)
        for _ in range(depth):
            a, b, c = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
            ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
            tris = np.concatenate(
                [
                    np.stack([a, ab, ca], axis=-2),
                    np.stack([ab, b, bc], axis=-2),
                    np.stack([ca, bc, c], axis=-2),
                    np.stack([ab, bc, ca], axis=-2),
                ],
                axis=1,
            )  # (N, 4^i, 3, 3)
        ref_pts, ref_w = triangle_rule(order)
        l1, l2 = ref_pts[:, 0], ref_pts[:, 1]
        shape = np.stack([1.0 - l1 - l2, l1, l2], axis=1)  # (nq, 3)
        qp = np.einsum("qv,ncvd->ncqd", shape, tris)
        n = self.num_elements
        # midpoint children of a flat triangle have exactly area/4^depth
        child_area = self.areas / 4.0**depth
        qw = (2.0 * child_area)[:, None, None] * ref_w[None, None, :]
        nqf = qp.shape[1] * qp.shape[2]
        return qp.reshape(n, nqf, 3), np.broadcast_to(
            qw, (n, tris.shape[1], len(ref_w))
        ).reshape(n, nqf)

    def quad_points(self, order: int = 3):
        """Gauss points/weights on every element: returns
        (points (N, nq, 3), weights (N, nq)) with weights including the
        Jacobian (so sum(w) = element area). Quads take the 2 x 2 tensor
        rule whatever ``order``."""
        pts = self.nodes[self.elements]
        if self.nodes_per_element == 3:
            ref_pts, ref_w = triangle_rule(order)
            l1 = ref_pts[:, 0]
            l2 = ref_pts[:, 1]
            l0 = 1.0 - l1 - l2
            shape = np.stack([l0, l1, l2], axis=1)  # (nq, 3)
            qp = np.einsum("qv,nvd->nqd", shape, pts)
            qw = (2.0 * self.areas)[:, None] * ref_w[None, :]
            return qp, qw
        # bilinear quad: tensor Gauss with position-dependent Jacobian
        ref_pts, ref_w = quad_rule(2)
        phi, _ = shape_functions(QUAD, ref_pts)  # (nq, 4)
        qp = np.einsum("qv,nvd->nqd", phi, pts)
        qw = _bilinear_jacobian(pts, ref_pts) * ref_w[None, :]
        return qp, qw

    def orient_outward(self, interior_point=(0.0, 0.0, 0.0)) -> "SurfaceMesh":
        """Flip elements whose normal points toward the interior point."""
        to_center = self.centers - np.asarray(interior_point)[None, :]
        flip = np.einsum("nd,nd->n", to_center, self.normals) < 0
        elems = self.elements.copy()
        rev = [0, 2, 1] if self.nodes_per_element == 3 else [0, 3, 2, 1]
        elems[flip] = elems[flip][:, rev]
        return SurfaceMesh(self.nodes, elems)


def _bilinear_jacobian(pts, ref_pts):
    """Surface Jacobian sqrt(det(J^T J)) (N, nq) of the bilinear patches
    ``pts`` (N, 4, 3) at the reference points."""
    _, grad = shape_functions(QUAD, ref_pts)  # (nq, 4, 2)
    jac = np.einsum("nvd,qvk->nqdk", pts, grad)  # (N, nq, 3, 2)
    metric = np.einsum("nqdk,nqdl->nqkl", jac, jac)
    return np.sqrt(np.abs(np.linalg.det(metric)))


def icosphere(radius: float = 1.0, subdivisions: int = 2) -> SurfaceMesh:
    """Icosphere: 20 * 4^s triangles."""
    verts, faces = _icosphere_surface(subdivisions)
    return SurfaceMesh(radius * verts, faces).orient_outward()


def uv_sphere(radius: float = 1.0, n_theta: int = 12, n_phi: int = 24) -> SurfaceMesh:
    """Latitude-longitude sphere: two polar fans and n_theta - 2 bands of
    2 n_phi triangles each, 2 n_phi (n_theta - 1) in all."""
    nodes = [np.array([0.0, 0.0, radius]), np.array([0.0, 0.0, -radius])]
    ring_ids = []
    for i in range(1, n_theta):
        theta = np.pi * i / n_theta
        ring = []
        for j in range(n_phi):
            phi = 2 * np.pi * j / n_phi
            ring.append(len(nodes))
            nodes.append(
                radius
                * np.array(
                    [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]
                )
            )
        ring_ids.append(ring)
    faces = []
    top, bottom = 0, 1
    for j in range(n_phi):
        faces.append([top, ring_ids[0][j], ring_ids[0][(j + 1) % n_phi]])
        faces.append([bottom, ring_ids[-1][(j + 1) % n_phi], ring_ids[-1][j]])
    for i in range(len(ring_ids) - 1):
        for j in range(n_phi):
            a, b = ring_ids[i][j], ring_ids[i][(j + 1) % n_phi]
            c, d = ring_ids[i + 1][j], ring_ids[i + 1][(j + 1) % n_phi]
            faces.append([a, c, d])
            faces.append([a, d, b])
    return SurfaceMesh(np.asarray(nodes), np.asarray(faces, np.int64)).orient_outward()


def cylinder_mesh(
    radius: float = 1.0,
    height: float = 2.0,
    n_circ: int = 24,
    n_height: int = 8,
    closed: bool = True,
) -> SurfaceMesh:
    """Cylinder along z: n_height bands of 2 n_circ triangles, and with
    ``closed`` a fan of n_circ triangles on each end."""
    nodes = []
    rings = []
    for i in range(n_height + 1):
        z = -height / 2 + height * i / n_height
        ring = []
        for j in range(n_circ):
            phi = 2 * np.pi * j / n_circ
            ring.append(len(nodes))
            nodes.append([radius * np.cos(phi), radius * np.sin(phi), z])
        rings.append(ring)
    faces = []
    for i in range(n_height):
        for j in range(n_circ):
            a, b = rings[i][j], rings[i][(j + 1) % n_circ]
            c, d = rings[i + 1][j], rings[i + 1][(j + 1) % n_circ]
            faces.append([a, b, d])
            faces.append([a, d, c])
    if closed:
        top_c = len(nodes)
        nodes.append([0.0, 0.0, height / 2])
        bot_c = len(nodes)
        nodes.append([0.0, 0.0, -height / 2])
        for j in range(n_circ):
            faces.append([top_c, rings[-1][j], rings[-1][(j + 1) % n_circ]])
            faces.append([bot_c, rings[0][(j + 1) % n_circ], rings[0][j]])
    return SurfaceMesh(np.asarray(nodes, float), np.asarray(faces, np.int64)).orient_outward()


def cube_sphere(radius: float = 1.0, n: int = 8) -> SurfaceMesh:
    """All-quad sphere: the cube's faces, n x n quads each, projected onto
    the sphere: 6 n^2 quadrilateral elements."""
    nodes = []
    node_id = {}

    def nid(p):
        key = tuple(np.round(p, 12))
        if key not in node_id:
            node_id[key] = len(nodes)
            nodes.append(p)
        return node_id[key]

    faces = []
    axes = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
    for ax, u_ax, v_ax in axes:
        for side in (-1.0, 1.0):
            for i in range(n):
                for j in range(n):
                    quad = []
                    for du, dv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                        p = np.zeros(3)
                        p[ax] = side
                        p[u_ax] = -1 + 2 * (i + du) / n
                        p[v_ax] = -1 + 2 * (j + dv) / n
                        p = radius * p / np.linalg.norm(p)
                        quad.append(nid(p))
                    faces.append(quad)
    return SurfaceMesh(np.asarray(nodes), np.asarray(faces, np.int64)).orient_outward()
