"""Core value types (counterpart of mathaudio_tpu/common/types.py; pure
Python and numpy): ``Point3D``, and ``RoomMesh``, the struct-of-arrays
surface mesh the room BEM consumes."""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from mathaudio_tpu_torch.xtypes import (  # noqa: F401  re-exported like the reference's
    AIR_DENSITY,
    REFERENCE_PRESSURE,
    SPEED_OF_SOUND,
    lin_space,
    log_space,
    pressure_to_spl,
    wavenumber,
)


@dataclasses.dataclass
class Point3D:
    """3-vector with a small algebra."""

    x: float
    y: float
    z: float

    @classmethod
    def from_array(cls, a) -> "Point3D":
        return cls(float(a[0]), float(a[1]), float(a[2]))

    def to_array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z])

    def __add__(self, o):
        return Point3D(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Point3D(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s: float):
        return Point3D(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def dot(self, o) -> float:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o) -> "Point3D":
        return Point3D(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm(self) -> float:
        return math.sqrt(self.dot(self))

    def distance_to(self, o) -> float:
        return (self - o).norm()

    def normalized(self) -> "Point3D":
        n = self.norm()
        return Point3D(self.x / n, self.y / n, self.z / n) if n > 0 else self


@dataclasses.dataclass
class SurfaceElement:
    """Triangle or quad surface element."""

    connectivity: List[int]
    centroid: np.ndarray
    normal: np.ndarray
    area: float

    @property
    def is_triangle(self) -> bool:
        return len(self.connectivity) == 3


@dataclasses.dataclass
class RoomMesh:
    """Surface mesh of a room: nodes + elements with derived centroid /
    normal / area arrays."""

    nodes: np.ndarray  # (Nn, 3)
    elements: np.ndarray  # (N, 3) triangles (quads split upstream)

    def __post_init__(self):
        pts = self.nodes[self.elements]
        cr = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0])
        nrm = np.linalg.norm(cr, axis=1)
        self.areas = 0.5 * nrm
        self.normals = cr / np.maximum(nrm, 1e-300)[:, None]
        self.centroids = pts.mean(axis=1)

    @property
    def num_elements(self) -> int:
        return len(self.elements)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    def total_area(self) -> float:
        return float(self.areas.sum())

    def element(self, i: int) -> SurfaceElement:
        return SurfaceElement(list(self.elements[i]), self.centroids[i], self.normals[i],
                              float(self.areas[i]))

    def to_surface_mesh(self):
        """Adapter to the BEM engine's SurfaceMesh."""
        from mathaudio_tpu_torch.bem.mesh import SurfaceMesh

        return SurfaceMesh(self.nodes, self.elements)
