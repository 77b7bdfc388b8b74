"""AnalyticalSolution container and error metrics (counterpart of
mathaudio_tpu/wave/analytical/solution.py); positions and pressures are
tensors."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from mathaudio_tpu_torch.xtypes import SPEED_OF_SOUND, as_real


def _tensor(a, like=None):
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(a, device=None if like is None else like.device)


def l2_error(p, p_ref):
    """sqrt(sum |p - p_ref|^2)."""
    p = _tensor(p)
    d = p - _tensor(p_ref, p)
    return torch.sqrt(torch.sum(torch.abs(d) ** 2))


def relative_l2_error(p, p_ref):
    """l2_error / ||p_ref||, falling back to the absolute error for tiny
    norms."""
    err = l2_error(p, p_ref)
    norm = torch.sqrt(torch.sum(torch.abs(_tensor(p_ref, err)) ** 2))
    return torch.where(norm < 1e-15, err, err / torch.where(norm < 1e-15, 1.0, norm))


def linf_error(p, p_ref):
    """max |p - p_ref|."""
    p = _tensor(p)
    return torch.max(torch.abs(p - _tensor(p_ref, p)))


def from_spherical(r, theta, phi, *, dtype=None, device=None):
    """(r, theta, phi) -> (x, y, z), theta = polar angle from +z."""
    r = as_real(r, dtype, device)
    theta, phi = as_real(theta, r.dtype, r.device), as_real(phi, r.dtype, r.device)
    st = torch.sin(theta)
    return torch.stack([r * st * torch.cos(phi), r * st * torch.sin(phi), r * torch.cos(theta)],
                       dim=-1)


def from_polar(r, theta, *, dtype=None, device=None):
    """(r, theta) -> (x, y)."""
    r = as_real(r, dtype, device)
    theta = as_real(theta, r.dtype, r.device)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


@dataclasses.dataclass
class AnalyticalSolution:
    """Named analytical solution on a set of evaluation points."""

    name: str
    dimensions: int
    positions: torch.Tensor  # (N, dims)
    pressure: torch.Tensor  # (N,) complex
    wave_number: float
    frequency: float
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def magnitude(self):
        return torch.abs(self.pressure)

    def phase(self):
        return torch.angle(self.pressure)

    def real(self):
        return torch.real(self.pressure)

    def imag(self):
        return torch.imag(self.pressure)

    def l2_error(self, other: "AnalyticalSolution"):
        return l2_error(self.pressure, other.pressure)

    def relative_l2_error(self, other: "AnalyticalSolution"):
        return relative_l2_error(self.pressure, other.pressure)

    def linf_error(self, other: "AnalyticalSolution"):
        return linf_error(self.pressure, other.pressure)


def frequency_of(wave_number: float, c: float = SPEED_OF_SOUND) -> float:
    return float(wave_number) * c / (2.0 * math.pi)
