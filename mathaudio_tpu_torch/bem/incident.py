"""Incident fields (counterpart of mathaudio_tpu/bem/incident.py): plane
waves and point sources with pressure + normal-derivative evaluation,
for the RHS of the (Burton–Miller) collocation system.

``points`` and ``normals`` are real (N, 3) tensors and set the dtype and
device of the result. ``k`` is a float or a real tensor of any shape
(usually the (F,) band); the result has shape ``k.shape + (N,)``: the
reference's ``vmap`` over wavenumbers written out as a leading batch
dimension.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mathaudio_tpu_torch.utils.profiling import count
from mathaudio_tpu_torch.xtypes import complex_dtype_for


@dataclasses.dataclass
class IncidentField:
    """kind: 'plane' (direction) or 'point' (position, amplitude)."""

    kind: str
    direction: Optional[np.ndarray] = None  # unit propagation direction
    position: Optional[np.ndarray] = None
    amplitude: complex = 1.0

    def _k(self, points: torch.Tensor, k) -> torch.Tensor:
        return torch.as_tensor(k, dtype=points.dtype, device=points.device)[..., None]

    def _distance(self, points: torch.Tensor):
        count("host_sync.upload")
        src = torch.as_tensor(self.position, dtype=points.dtype, device=points.device)
        rv = points - src
        r = torch.linalg.vector_norm(rv, dim=-1)
        return rv, torch.where(r < 1e-15, 1.0, r)

    def pressure(self, points: torch.Tensor, k) -> torch.Tensor:
        cd = complex_dtype_for(points.dtype)
        kk = self._k(points, k)
        count("host_sync.upload")
        amp = torch.tensor(self.amplitude, dtype=cd, device=points.device)
        if self.kind == "plane":
            count("host_sync.upload")
            d = torch.as_tensor(self.direction, dtype=points.dtype, device=points.device)
            return amp * torch.exp(1j * (kk * (points @ d)).to(cd))
        _, rs = self._distance(points)
        return amp * torch.exp(1j * (kk * rs).to(cd)) / (4.0 * math.pi * rs)

    def normal_derivative(self, points: torch.Tensor, normals: torch.Tensor, k) -> torch.Tensor:
        """dp_inc/dn at the points."""
        cd = complex_dtype_for(points.dtype)
        kk = self._k(points, k)
        p = self.pressure(points, k)
        if self.kind == "plane":
            count("host_sync.upload")
            d = torch.as_tensor(self.direction, dtype=points.dtype, device=points.device)
            return 1j * kk * (normals @ d).to(cd) * p
        rv, rs = self._distance(points)
        r_dot_n = torch.sum(rv * normals, dim=-1) / rs
        return (1j * kk - 1.0 / rs).to(cd) * p * r_dot_n.to(cd)


def plane_wave(direction=(0.0, 0.0, 1.0), amplitude: complex = 1.0) -> IncidentField:
    d = np.asarray(direction, float)
    return IncidentField("plane", direction=d / np.linalg.norm(d), amplitude=amplitude)


def point_source(position, amplitude: complex = 1.0) -> IncidentField:
    return IncidentField("point", position=np.asarray(position, float), amplitude=amplitude)
