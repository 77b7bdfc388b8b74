"""Core value types (counterpart of mathaudio_tpu/common/types.py:
``Point3D``; pure Python and numpy)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


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
