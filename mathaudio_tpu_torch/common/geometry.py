"""Room geometries and surface mesh generation (counterpart of
mathaudio_tpu/common/geometry.py; host numpy, node for node and face for
face the reference's meshes).

Rectangular and L-shaped rooms; surface meshes at a target element
density (elements/meter), with the adaptive variant refining walls near
sources based on the acoustic wavelength.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mathaudio_tpu_torch.common.source import Source
from mathaudio_tpu_torch.common.types import Point3D, RoomMesh


def _quad_wall(origin, u_dir, v_dir, u_len, v_len, nu, nv, nodes, faces):
    """Triangulated rectangular wall patch; appends into nodes/faces."""
    base = len(nodes)
    u = np.asarray(u_dir, float)
    v = np.asarray(v_dir, float)
    o = np.asarray(origin, float)
    for j in range(nv + 1):
        for i in range(nu + 1):
            nodes.append(o + u * (u_len * i / nu) + v * (v_len * j / nv))
    for j in range(nv):
        for i in range(nu):
            n00 = base + j * (nu + 1) + i
            n10 = n00 + 1
            n01 = n00 + (nu + 1)
            n11 = n01 + 1
            faces.append([n00, n10, n11])
            faces.append([n00, n11, n01])


def _merge_duplicate_nodes(nodes: np.ndarray, faces: np.ndarray, tol=1e-9):
    key = np.round(nodes / tol).astype(np.int64)
    _, uniq_idx, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    return nodes[uniq_idx], inverse[faces]


@dataclasses.dataclass
class RectangularRoom:
    """width (x) x depth (y) x height (z), corner at origin."""

    width: float
    depth: float
    height: float

    def volume(self) -> float:
        return self.width * self.depth * self.height

    def dimensions(self) -> Tuple[float, float, float]:
        return (self.width, self.depth, self.height)

    def contains(self, p: Point3D) -> bool:
        return (
            0 <= p.x <= self.width and 0 <= p.y <= self.depth and 0 <= p.z <= self.height
        )

    def _walls(self):
        w, d, h = self.width, self.depth, self.height
        # (origin, u, v, u_len, v_len): floor, ceiling, 4 walls; normals
        # fixed afterwards to point into the room... BEM room solver uses
        # outward-from-fluid convention handled downstream.
        return [
            ((0, 0, 0), (1, 0, 0), (0, 1, 0), w, d),  # floor
            ((0, 0, h), (0, 1, 0), (1, 0, 0), d, w),  # ceiling
            ((0, 0, 0), (0, 0, 1), (1, 0, 0), h, w),  # front y=0
            ((0, d, 0), (1, 0, 0), (0, 0, 1), w, h),  # back y=d
            ((0, 0, 0), (0, 1, 0), (0, 0, 1), d, h),  # left x=0
            ((w, 0, 0), (0, 0, 1), (0, 1, 0), h, d),  # right x=w
        ]

    def generate_mesh(self, elements_per_meter: int) -> RoomMesh:
        """Uniform surface mesh at the given density."""
        nodes: List[np.ndarray] = []
        faces: List[List[int]] = []
        for origin, u, v, ul, vl in self._walls():
            nu = max(1, round(ul * elements_per_meter))
            nv = max(1, round(vl * elements_per_meter))
            _quad_wall(origin, u, v, ul, vl, nu, nv, nodes, faces)
        n, f = _merge_duplicate_nodes(np.asarray(nodes), np.asarray(faces, np.int64))
        return RoomMesh(n, f)

    def generate_adaptive_mesh(
        self,
        base_elements_per_meter: int,
        frequency: float,
        sources: Sequence[Source],
        speed_of_sound: float = 343.0,
    ) -> RoomMesh:
        """Refine walls near sources: density doubles for walls within a
        wavelength of a source."""
        wavelength = speed_of_sound / max(frequency, 1e-9)
        nodes: List[np.ndarray] = []
        faces: List[List[int]] = []
        for origin, u, v, ul, vl in self._walls():
            o = np.asarray(origin, float)
            center = o + np.asarray(u, float) * ul / 2 + np.asarray(v, float) * vl / 2
            density = base_elements_per_meter
            for s in sources:
                if np.linalg.norm(center - s.position.to_array()) < wavelength:
                    density = base_elements_per_meter * 2
                    break
            nu = max(1, round(ul * density))
            nv = max(1, round(vl * density))
            _quad_wall(origin, u, v, ul, vl, nu, nv, nodes, faces)
        n, f = _merge_duplicate_nodes(np.asarray(nodes), np.asarray(faces, np.int64))
        return RoomMesh(n, f)

    def get_edges(self) -> List[Tuple[Point3D, Point3D]]:
        w, d, h = self.width, self.depth, self.height
        c = [Point3D(x, y, z) for z in (0, h) for y in (0, d) for x in (0, w)]
        idx = [
            (0, 1), (1, 3), (3, 2), (2, 0),
            (4, 5), (5, 7), (7, 6), (6, 4),
            (0, 4), (1, 5), (2, 6), (3, 7),
        ]
        return [(c[i], c[j]) for i, j in idx]


@dataclasses.dataclass
class LShapedRoom:
    """Main section w1 x d1 plus extension w2 x d2 behind it: footprint = [0,w1]x[0,d1] union [0,w2]x[d1,d1+d2]."""

    width1: float
    depth1: float
    width2: float
    depth2: float
    height: float

    def volume(self) -> float:
        return (self.width1 * self.depth1 + self.width2 * self.depth2) * self.height

    def dimensions(self) -> Tuple[float, float, float]:
        return (max(self.width1, self.width2), self.depth1 + self.depth2, self.height)

    def contains(self, p: Point3D) -> bool:
        if not (0 <= p.z <= self.height):
            return False
        if 0 <= p.y <= self.depth1:
            return 0 <= p.x <= self.width1
        if self.depth1 <= p.y <= self.depth1 + self.depth2:
            return 0 <= p.x <= self.width2
        return False

    def _walls(self):
        w1, d1, w2, d2, h = self.width1, self.depth1, self.width2, self.depth2, self.height
        walls = [
            # floors and ceilings (two rectangles each)
            ((0, 0, 0), (1, 0, 0), (0, 1, 0), w1, d1),
            ((0, d1, 0), (1, 0, 0), (0, 1, 0), w2, d2),
            ((0, 0, h), (0, 1, 0), (1, 0, 0), d1, w1),
            ((0, d1, h), (0, 1, 0), (1, 0, 0), d2, w2),
            # outer walls
            ((0, 0, 0), (0, 0, 1), (1, 0, 0), h, w1),  # front y=0
            ((0, d1 + d2, 0), (1, 0, 0), (0, 0, 1), w2, h),  # back
            ((0, 0, 0), (0, 1, 0), (0, 0, 1), d1 + d2, h),  # left x=0
            ((w1, 0, 0), (0, 0, 1), (0, 1, 0), h, d1),  # right main
            ((w2, d1, 0), (0, 0, 1), (0, 1, 0), h, d2),  # right extension
        ]
        if w1 > w2:
            # step wall at y=d1 between x=w2..w1
            walls.append(((w2, d1, 0), (1, 0, 0), (0, 0, 1), w1 - w2, h))
        elif w2 > w1:
            walls.append(((w1, d1, 0), (1, 0, 0), (0, 0, 1), w2 - w1, h))
        return walls

    def generate_mesh(self, elements_per_meter: int) -> RoomMesh:
        nodes: List[np.ndarray] = []
        faces: List[List[int]] = []
        for origin, u, v, ul, vl in self._walls():
            nu = max(1, round(ul * elements_per_meter))
            nv = max(1, round(vl * elements_per_meter))
            _quad_wall(origin, u, v, ul, vl, nu, nv, nodes, faces)
        n, f = _merge_duplicate_nodes(np.asarray(nodes), np.asarray(faces, np.int64))
        return RoomMesh(n, f)

    def generate_adaptive_mesh(self, base_epm, frequency, sources, speed_of_sound=343.0):
        # same refinement policy as the rectangular room
        wavelength = speed_of_sound / max(frequency, 1e-9)
        nodes: List[np.ndarray] = []
        faces: List[List[int]] = []
        for origin, u, v, ul, vl in self._walls():
            o = np.asarray(origin, float)
            center = o + np.asarray(u, float) * ul / 2 + np.asarray(v, float) * vl / 2
            density = base_epm
            for s in sources:
                if np.linalg.norm(center - s.position.to_array()) < wavelength:
                    density = base_epm * 2
                    break
            nu = max(1, round(ul * density))
            nv = max(1, round(vl * density))
            _quad_wall(origin, u, v, ul, vl, nu, nv, nodes, faces)
        n, f = _merge_duplicate_nodes(np.asarray(nodes), np.asarray(faces, np.int64))
        return RoomMesh(n, f)

    def get_edges(self):
        # outline edges of the L footprint at z = 0 and z = h + verticals
        w1, d1, w2, d2, h = self.width1, self.depth1, self.width2, self.depth2, self.height
        loop = [
            (0, 0), (w1, 0), (w1, d1), (w2, d1), (w2, d1 + d2), (0, d1 + d2)
        ]
        edges = []
        for z in (0.0, h):
            for i in range(len(loop)):
                a, b = loop[i], loop[(i + 1) % len(loop)]
                edges.append((Point3D(a[0], a[1], z), Point3D(b[0], b[1], z)))
        for x, y in loop:
            edges.append((Point3D(x, y, 0.0), Point3D(x, y, h)))
        return edges


@dataclasses.dataclass
class RoomGeometry:
    """Tagged union over room shapes."""

    shape: object  # RectangularRoom | LShapedRoom

    @classmethod
    def rectangular(cls, width, depth, height):
        return cls(RectangularRoom(width, depth, height))

    @classmethod
    def lshaped(cls, width1, depth1, width2, depth2, height):
        return cls(LShapedRoom(width1, depth1, width2, depth2, height))

    def generate_mesh(self, elements_per_meter: int) -> RoomMesh:
        return self.shape.generate_mesh(elements_per_meter)

    def generate_adaptive_mesh(self, base_epm, frequency, sources, c=343.0) -> RoomMesh:
        return self.shape.generate_adaptive_mesh(base_epm, frequency, sources, c)

    def dimensions(self):
        return self.shape.dimensions()

    def volume(self):
        return self.shape.volume()

    def get_edges(self):
        return self.shape.get_edges()

    def contains(self, p: Point3D) -> bool:
        return self.shape.contains(p)
