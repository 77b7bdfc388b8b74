"""2D analytical solutions (counterpart of
mathaudio_tpu/wave/analytical/solutions_2d.py). The rigid-cylinder series
is one contraction over orders. Each evaluator takes keyword-only
``dtype`` (real precision, default float32) and ``device`` (default the
GPU).

An order whose H_n^(1)'(ka) overflows the working precision (the upward Y
recurrence does so at high orders and small ka, sooner in float32) takes
its coefficient's limit, a_n = 0, and adds nothing to the series, where
the plain division would give inf/inf = NaN.
"""

from __future__ import annotations

import math

import torch

from mathaudio_tpu_torch.wave.analytical.solution import (
    AnalyticalSolution,
    frequency_of,
    from_polar,
)
from mathaudio_tpu_torch.wave.special.bessel import bessel_derivative_all, bessel_jn_yn_all
from mathaudio_tpu_torch.xtypes import as_real, complex_dtype_for, default_float, resolve_device


def _i_pow_n(num_terms, dtype, device):
    n = torch.arange(num_terms, dtype=dtype, device=device)
    return torch.exp(1j * (n * math.pi / 2.0).to(complex_dtype_for(dtype)))


def _coefficients(jp, yp, i_pow_n):
    """a_n = -J_n'/H_n' i^n, 0 where H_n' overflowed (its limit)."""
    finite = torch.isfinite(yp)
    hp = torch.complex(jp, torch.where(finite, yp, 0.0))
    return torch.where(finite, -jp / hp * i_pow_n, 0.0)


def _scattered_terms(a_n, h_all):
    """a_n H_n(kr) per order and radius, 0 where a_n is 0: an order whose
    H_n' overflowed at ka may overflow H_n at kr too."""
    return torch.where(a_n[:, None] == 0, 0.0, a_n[:, None] * h_all)


def rigid_cylinder_coefficients(ka, num_terms: int, max_arg: float = 120.0, *, dtype=None,
                                device=None):
    """a_n = -J_n'(ka)/H_n^(1)'(ka) * i^n for a rigid cylinder. Returns
    (num_terms,) complex."""
    ka = as_real(ka, dtype or default_float(), device)
    j_all, y_all = bessel_jn_yn_all(num_terms, ka, max_arg=max_arg)
    jp = bessel_derivative_all(j_all, ka)[:num_terms]
    yp = bessel_derivative_all(y_all, ka)[:num_terms]
    return _coefficients(jp, yp, _i_pow_n(num_terms, ka.dtype, ka.device))


def cylinder_scattering_2d(wave_number: float, radius: float, num_terms: int, r_points,
                           theta_points, max_arg: float = 120.0, *, dtype=None, device=None):
    """Total field around a rigid cylinder hit by a +x plane wave:
    p = exp(ikr cos theta) + sum_n eps_n a_n H_n^(1)(kr) cos(n theta).
    Grid = cartesian product r x theta."""
    r_points = as_real(r_points, dtype or default_float(), device)
    theta_points = as_real(theta_points, r_points.dtype, r_points.device)
    rdt, dev = r_points.dtype, r_points.device
    ka = wave_number * radius
    a_n = rigid_cylinder_coefficients(ka, num_terms, max_arg=max_arg, dtype=rdt, device=dev)

    kr = wave_number * r_points  # (R,)
    j_all, y_all = bessel_jn_yn_all(num_terms - 1, kr, max_arg=max_arg)
    h_all = torch.complex(j_all, y_all)  # (num_terms, R)

    n = torch.arange(num_terms, dtype=rdt, device=dev)
    eps = torch.where(n == 0, 1.0, 2.0)
    cosn = torch.cos(n[:, None] * theta_points[None, :])  # (num_terms, T)

    # scattered(r, theta) = sum_n [eps_n a_n H_n(kr)] cos(n theta)
    weighted = eps[:, None] * _scattered_terms(a_n, h_all)  # (num_terms, R)
    scattered = torch.einsum("nr,nt->rt", weighted, cosn.to(weighted.dtype))
    incident = torch.exp(1j * (kr[:, None] * torch.cos(theta_points)[None, :])
                         .to(complex_dtype_for(rdt)))
    total = (incident + scattered).reshape(-1)

    rr, tt = torch.meshgrid(r_points, theta_points, indexing="ij")
    return AnalyticalSolution(
        name=f"2D Cylinder Scattering (ka={ka:.2f})",
        dimensions=2,
        positions=from_polar(rr.reshape(-1), tt.reshape(-1)),
        pressure=total,
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={
            "radius": radius,
            "ka": ka,
            "num_terms": num_terms,
            "boundary_condition": "rigid",
            "regime": classify_regime_2d(ka),
        },
    )


def classify_regime_2d(ka: float) -> str:
    if ka < 0.3:
        return "Rayleigh (ka << 1)"
    if ka < 3.0:
        return "Resonance (ka ~ 1)"
    return "Geometric (ka >> 1)"


def cylinder_directivity_2d(wave_number: float, radius: float, num_terms: int, theta_points,
                            max_arg: float = 120.0, *, dtype=None, device=None):
    """D(theta) = sum_n eps_n a_n cos(n theta)."""
    theta_points = as_real(theta_points, dtype or default_float(), device)
    a_n = rigid_cylinder_coefficients(wave_number * radius, num_terms, max_arg=max_arg,
                                      dtype=theta_points.dtype, device=theta_points.device)
    n = torch.arange(num_terms, dtype=theta_points.dtype, device=theta_points.device)
    eps = torch.where(n == 0, 1.0, 2.0)
    cosn = torch.cos(n[:, None] * theta_points[None, :])
    return torch.einsum("n,nt->t", eps * a_n, cosn.to(a_n.dtype))


def cylinder_scattering_cross_section_2d(wave_number: float, radius: float, num_terms: int,
                                         max_arg: float = 120.0, *, dtype=None, device=None):
    """sigma = (4/k) sum_n eps_n |a_n|^2."""
    a_n = rigid_cylinder_coefficients(wave_number * radius, num_terms, max_arg=max_arg,
                                      dtype=dtype, device=device)
    eps = torch.where(torch.arange(num_terms, device=a_n.device) == 0, 1.0, 2.0)
    return 4.0 / wave_number * torch.sum(eps * torch.abs(a_n) ** 2)


def plane_wave_2d(wave_number: float, direction: float, x_points, y_points, *, dtype=None,
                  device=None):
    """p(x, y) = exp(ik (x cos t + y sin t)), grid = x cross y."""
    x = as_real(x_points, dtype or default_float(), device)
    y = as_real(y_points, x.dtype, x.device)
    xx, yy = torch.meshgrid(x, y, indexing="ij")
    phase = wave_number * (xx * math.cos(direction) + yy * math.sin(direction))
    p = torch.exp(1j * phase.reshape(-1).to(complex_dtype_for(x.dtype)))
    return AnalyticalSolution(
        name=f"2D Plane Wave (k={wave_number}, theta={direction:.2f})",
        dimensions=2,
        positions=torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1),
        pressure=p,
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={"direction": direction, "wavelength": 2.0 * math.pi / wave_number},
    )
