"""Surface meshes for BEM (counterpart of mathaudio_tpu/bem/mesh.py;
pure numpy). Constant triangular elements, struct-of-arrays layout:
everything the kernels need (centers, normals, areas, quadrature points)
is precomputed into flat arrays that the sweep moves to the device once.

Quadrilateral elements need the bilinear shape functions, which this
package does not have yet: ``SurfaceMesh`` raises a ``ValueError`` for
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mathaudio_tpu_torch.fem.mesh import _icosphere_surface
from mathaudio_tpu_torch.fem.quadrature import triangle_rule


@dataclasses.dataclass
class SurfaceMesh:
    """Closed surface of constant triangular (N, 3) elements; normals
    point away from the body (into the exterior acoustic domain)."""

    nodes: np.ndarray  # (Nn, 3)
    elements: np.ndarray  # (N, 3) int

    def __post_init__(self):
        if self.elements.shape[1] != 3:
            raise ValueError(
                f"SurfaceMesh takes triangles only; quadrilateral elements "
                f"({self.elements.shape[1]} nodes) are not ported yet"
            )
        pts = self.nodes[self.elements]
        v1 = pts[:, 1] - pts[:, 0]
        v2 = pts[:, 2] - pts[:, 0]
        cr = np.cross(v1, v2)
        nrm = np.linalg.norm(cr, axis=1)
        self.areas = 0.5 * nrm
        self.normals = cr / np.maximum(nrm, 1e-300)[:, None]
        self.centers = pts.mean(axis=1)

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

    def quad_points(self, order: int = 3):
        """Gauss points/weights on every element: returns
        (points (N, nq, 3), weights (N, nq)) with weights including the
        Jacobian (so sum(w) = element area)."""
        pts = self.nodes[self.elements]
        ref_pts, ref_w = triangle_rule(order)
        l1 = ref_pts[:, 0]
        l2 = ref_pts[:, 1]
        l0 = 1.0 - l1 - l2
        shape = np.stack([l0, l1, l2], axis=1)  # (nq, 3)
        qp = np.einsum("qv,nvd->nqd", shape, pts)
        qw = (2.0 * self.areas)[:, None] * ref_w[None, :]
        return qp, qw

    def orient_outward(self, interior_point=(0.0, 0.0, 0.0)) -> "SurfaceMesh":
        """Flip elements whose normal points toward the interior point."""
        to_center = self.centers - np.asarray(interior_point)[None, :]
        flip = np.einsum("nd,nd->n", to_center, self.normals) < 0
        elems = self.elements.copy()
        elems[flip] = elems[flip][:, [0, 2, 1]]
        return SurfaceMesh(self.nodes, elems)


def icosphere(radius: float = 1.0, subdivisions: int = 2) -> SurfaceMesh:
    """Icosphere: 20 * 4^s triangles."""
    verts, faces = _icosphere_surface(subdivisions)
    return SurfaceMesh(radius * verts, faces).orient_outward()
