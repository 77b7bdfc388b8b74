"""1D analytical solutions (counterpart of
mathaudio_tpu/wave/analytical/solutions_1d.py). Each takes keyword-only
``dtype`` (real precision, default float32) and ``device`` (default the
GPU)."""

from __future__ import annotations

import math

import torch

from mathaudio_tpu_torch.wave.analytical.solution import AnalyticalSolution, frequency_of
from mathaudio_tpu_torch.xtypes import complex_dtype_for, default_float, resolve_device


def _grid(x_min: float, x_max: float, num_points: int, dtype, device):
    return torch.linspace(x_min, x_max, num_points, dtype=dtype or default_float(),
                          device=resolve_device(device))


def _phase(kx):
    """exp(i kx) of a real tensor, in the matching complex dtype."""
    return torch.exp(1j * kx.to(complex_dtype_for(kx.dtype)))


def plane_wave_1d(wave_number: float, x_min: float, x_max: float, num_points: int, *,
                  dtype=None, device=None):
    """p(x) = exp(ikx)."""
    x = _grid(x_min, x_max, num_points, dtype, device)
    return AnalyticalSolution(
        name=f"1D Plane Wave (k={wave_number})",
        dimensions=1,
        positions=x[:, None],
        pressure=_phase(wave_number * x),
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={"x_min": x_min, "x_max": x_max},
    )


def standing_wave_1d(wave_number: float, x_min: float, x_max: float, num_points: int, *,
                     dtype=None, device=None):
    """p(x) = i sin(kx)."""
    x = _grid(x_min, x_max, num_points, dtype, device)
    return AnalyticalSolution(
        name=f"1D Standing Wave (k={wave_number})",
        dimensions=1,
        positions=x[:, None],
        pressure=1j * torch.sin(wave_number * x).to(complex_dtype_for(x.dtype)),
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={"x_min": x_min, "x_max": x_max},
    )


def damped_wave_1d(wave_number: float, absorption: float, x_min: float, x_max: float,
                   num_points: int, *, dtype=None, device=None):
    """p(x) = exp(-alpha x) exp(ikx)."""
    x = _grid(x_min, x_max, num_points, dtype, device)
    return AnalyticalSolution(
        name=f"1D Damped Wave (k={wave_number}, alpha={absorption})",
        dimensions=1,
        positions=x[:, None],
        pressure=torch.exp(-absorption * x) * _phase(wave_number * x),
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={
            "absorption": absorption,
            "penetration_depth": (1.0 / absorption) if absorption > 0 else float("inf"),
            "quality_factor": wave_number / (2.0 * absorption) if absorption > 0 else float("inf"),
        },
    )


def helmholtz_1d_mode(wave_number: float, length: float, mode_number: int, num_points: int, *,
                      dtype=None, device=None):
    """u'' + k^2 u = sin(n pi x / L), u(0)=u(L)=0
    => u = sin(n pi x/L) / (k^2 - (n pi/L)^2)."""
    if mode_number < 1:
        raise ValueError(f"mode_number must be >= 1, got {mode_number}")
    kn = mode_number * math.pi / length
    denom = wave_number**2 - kn**2
    if abs(denom) <= 1e-10:
        raise ValueError("resonance: k ~= n pi / L")
    x = _grid(0.0, length, num_points, dtype, device)
    u = torch.sin(mode_number * math.pi * x / length) / denom
    return AnalyticalSolution(
        name=f"1D Helmholtz Mode (k={wave_number}, n={mode_number})",
        dimensions=1,
        positions=x[:, None],
        pressure=u.to(complex_dtype_for(x.dtype)),
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={"length": length, "mode_number": mode_number},
    )
