"""3D analytical solutions: Mie sphere scattering and friends (counterpart
of mathaudio_tpu/wave/analytical/solutions_3d.py). Each evaluator takes
keyword-only ``dtype`` (real precision, default float32) and ``device``
(default the GPU).

An order whose h_n^(1)'(ka) overflows the working precision takes its
coefficient's limit, a_n = 0, and adds nothing to the series. The upward
y recurrence overflows float32 from order 19 at ka = 0.1 and from order 36
at ka = 2, where the plain division j_n'/h_n' gives inf/inf = NaN (the
reference does, with x64 off); a_n is far below float32's resolution of
the sum there.
"""

from __future__ import annotations

import math

import torch

from mathaudio_tpu_torch.wave.analytical.solution import (
    AnalyticalSolution,
    frequency_of,
    from_spherical,
)
from mathaudio_tpu_torch.wave.analytical.solutions_2d import _i_pow_n, _scattered_terms
from mathaudio_tpu_torch.wave.special.legendre import legendre_all
from mathaudio_tpu_torch.wave.special.spherical import (
    spherical_bessel_derivative,
    spherical_jn_yn_all,
)
from mathaudio_tpu_torch.xtypes import as_real, complex_dtype_for, default_float


def rigid_sphere_coefficients(ka, num_terms: int, max_arg: float = 120.0, *, dtype=None,
                              device=None):
    """a_n = j_n'(ka) / h_n^(1)'(ka) for a rigid sphere, 0 where h_n'
    overflowed (its limit). Returns (num_terms,) complex."""
    ka = as_real(ka, dtype or default_float(), device)
    j_all, y_all = spherical_jn_yn_all(num_terms, ka, max_arg=max_arg)
    jp = spherical_bessel_derivative(j_all, ka)[:num_terms]
    yp = spherical_bessel_derivative(y_all, ka)[:num_terms]
    finite = torch.isfinite(yp)
    hp = torch.complex(jp, torch.where(finite, yp, 0.0))
    return torch.where(finite, jp / hp, 0.0)


def classify_regime(ka: float) -> str:
    """Rayleigh / Mie / geometric."""
    if ka < 0.3:
        return "Rayleigh (ka << 1)"
    if ka < 3.0:
        return "Mie (ka ~ 1)"
    return "Geometric (ka >> 1)"


def _sphere_series(wave_number, num_terms, kr, cos_theta, a_n, scattered_only, max_arg):
    """sum_n (2n+1) i^n [j_n(kr) - a_n h_n(kr)] P_n(cos theta) on the
    cartesian product kr x theta."""
    j_all, y_all = spherical_jn_yn_all(num_terms - 1, kr, max_arg=max_arg)
    h_all = torch.complex(j_all, y_all)  # (num_terms, R)
    p_all = legendre_all(num_terms - 1, cos_theta)  # (num_terms, T)

    n = torch.arange(num_terms, dtype=kr.dtype, device=kr.device)
    pref = (2.0 * n + 1.0) * _i_pow_n(num_terms, kr.dtype, kr.device)  # (num_terms,)

    radial = -_scattered_terms(a_n, h_all)
    if not scattered_only:
        radial = radial + j_all
    return torch.einsum("nr,nt->rt", pref[:, None] * radial, p_all.to(radial.dtype))


def sphere_scattering_3d(wave_number: float, radius: float, num_terms: int, r_points,
                         theta_points, max_arg: float = 120.0, *, dtype=None, device=None):
    """Total field around a rigid sphere hit by a +z plane wave:
    p = sum_n (2n+1) i^n [j_n(kr) - a_n h_n^(1)(kr)] P_n(cos theta).
    Grid = cartesian product r x theta, phi = 0."""
    r_points = as_real(r_points, dtype or default_float(), device)
    theta_points = as_real(theta_points, r_points.dtype, r_points.device)
    ka = wave_number * radius
    a_n = rigid_sphere_coefficients(ka, num_terms, max_arg=max_arg, dtype=r_points.dtype,
                                    device=r_points.device)
    total = _sphere_series(wave_number, num_terms, wave_number * r_points,
                           torch.cos(theta_points), a_n, scattered_only=False,
                           max_arg=max_arg).reshape(-1)

    rr, tt = torch.meshgrid(r_points, theta_points, indexing="ij")
    positions = from_spherical(rr.reshape(-1), tt.reshape(-1), torch.zeros_like(rr).reshape(-1))
    return AnalyticalSolution(
        name=f"3D Sphere Scattering (ka={ka:.2f})",
        dimensions=3,
        positions=positions,
        pressure=total,
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={
            "radius": radius,
            "ka": ka,
            "num_terms": num_terms,
            "boundary_condition": "rigid",
            "regime": classify_regime(ka),
        },
    )


def sphere_scattered_pressure_3d(wave_number: float, radius: float, num_terms: int, points,
                                 max_arg: float = 120.0, *, dtype=None, device=None):
    """Scattered-only field p_s at arbitrary (N, 3) points for a rigid
    sphere at the origin, incident plane wave along +z."""
    points = as_real(points, dtype or default_float(), device)
    r = torch.linalg.vector_norm(points, dim=-1)
    safe_r = torch.where(r < 1e-30, 1.0, r)
    cos_theta = points[:, 2] / safe_r
    a_n = rigid_sphere_coefficients(wave_number * radius, num_terms, max_arg=max_arg,
                                    dtype=points.dtype, device=points.device)

    j_all, y_all = spherical_jn_yn_all(num_terms - 1, wave_number * r, max_arg=max_arg)
    h_all = torch.complex(j_all, y_all)  # (num_terms, N)
    p_all = legendre_all(num_terms - 1, cos_theta)  # (num_terms, N)
    n = torch.arange(num_terms, dtype=points.dtype, device=points.device)
    pref = (2.0 * n + 1.0) * _i_pow_n(num_terms, points.dtype, points.device)
    terms = pref[:, None] * (-_scattered_terms(a_n, h_all)) * p_all.to(h_all.dtype)
    return torch.sum(terms, dim=0)


def sphere_rcs_3d(wave_number: float, radius: float, num_terms: int, max_arg: float = 120.0, *,
                  dtype=None, device=None):
    """sigma = (4 pi / k^2) sum_n (2n+1) |a_n|^2."""
    a_n = rigid_sphere_coefficients(wave_number * radius, num_terms, max_arg=max_arg,
                                    dtype=dtype, device=device)
    n = torch.arange(num_terms, device=a_n.device)
    return 4.0 * math.pi / wave_number**2 * torch.sum((2 * n + 1) * torch.abs(a_n) ** 2)


def sphere_scattering_efficiency_3d(wave_number: float, radius: float, num_terms: int,
                                    max_arg: float = 120.0, *, dtype=None, device=None):
    """Q = sigma / (pi a^2)."""
    return sphere_rcs_3d(wave_number, radius, num_terms, max_arg=max_arg, dtype=dtype,
                         device=device) / (math.pi * radius**2)


def plane_wave_3d(wave_number: float, theta: float, phi: float, points, *, dtype=None,
                  device=None):
    """p = exp(i k . r), direction (theta, phi)."""
    points = as_real(points, dtype or default_float(), device)
    kvec = wave_number * torch.tensor(
        [math.sin(theta) * math.cos(phi), math.sin(theta) * math.sin(phi), math.cos(theta)],
        dtype=points.dtype, device=points.device)
    phase = points @ kvec
    return AnalyticalSolution(
        name=f"3D Plane Wave (k={wave_number})",
        dimensions=3,
        positions=points,
        pressure=torch.exp(1j * phase.to(complex_dtype_for(points.dtype))),
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={"theta": theta, "phi": phi},
    )


def _monopole(wave_number, radius, points, p_a):
    """p(a) (a/r) e^{ik(r - a)} at |points|."""
    r = torch.linalg.vector_norm(points, dim=-1)
    return p_a * (radius / r) * torch.exp(1j * (wave_number * (r - radius))
                                          .to(complex_dtype_for(points.dtype)))


def pulsating_sphere_3d(wave_number: float, radius: float, points, velocity: complex = 1.0,
                        density: float = 1.204, speed_of_sound: float = 343.0, *, dtype=None,
                        device=None):
    """Radiating (breathing-mode) sphere: uniform radial surface velocity
    v0 on r = a. With e^{-i omega t} and outgoing e^{+ikr}/r waves,

        p(r) = i rho c v0 * (ka/(i ka - 1)) * (a/r) * e^{ik(r-a)},

    so the surface pressure is i ka rho c v0 / (i ka - 1)."""
    points = as_real(points, dtype or default_float(), device)
    ka = wave_number * radius
    coef = 1j * complex(density * speed_of_sound * velocity) * ka / (1j * ka - 1.0)
    return AnalyticalSolution(
        name=f"3D Pulsating Sphere (ka={ka})",
        dimensions=3,
        positions=points,
        pressure=_monopole(wave_number, radius, points, coef),
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={"radius": radius, "velocity": complex(velocity)},
    )


def impedance_sphere_3d(wave_number: float, radius: float, points, velocity: complex = 1.0,
                        admittance: complex = 0.0, density: float = 1.204,
                        speed_of_sound: float = 343.0, *, dtype=None, device=None):
    """Pulsating sphere with a locally-reacting surface of normalized
    admittance beta: dp/dn = i omega rho v0 - i k beta p on r = a. The
    outgoing monopole ansatz p = A e^{ikr}/r gives the surface pressure

        p(a) = i rho c ka v0 / (i ka (1 + beta) - 1),

    the rigid-driven pulsating sphere at beta = 0 and a pressure-release
    surface (p -> 0) as |beta| -> inf."""
    points = as_real(points, dtype or default_float(), device)
    ka = wave_number * radius
    p_a = (1j * complex(density * speed_of_sound * velocity) * ka
           / (1j * ka * (1.0 + complex(admittance)) - 1.0))
    return AnalyticalSolution(
        name=f"3D Impedance Sphere (ka={ka}, beta={admittance})",
        dimensions=3,
        positions=points,
        pressure=_monopole(wave_number, radius, points, p_a),
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={"radius": radius, "velocity": complex(velocity),
                  "admittance": complex(admittance)},
    )


def point_source_3d(wave_number: float, source, points, *, dtype=None, device=None):
    """Monopole G(r) = exp(ikr)/(4 pi r)."""
    from mathaudio_tpu_torch.wave.special.helmholtz import greens_function_3d

    points = as_real(points, dtype or default_float(), device)
    source = as_real(source, points.dtype, points.device)
    r = torch.linalg.vector_norm(points - source, dim=-1)
    return AnalyticalSolution(
        name=f"3D Point Source (k={wave_number})",
        dimensions=3,
        positions=points,
        pressure=greens_function_3d(r, wave_number),
        wave_number=wave_number,
        frequency=frequency_of(wave_number),
        metadata={"source": [float(source[0]), float(source[1]), float(source[2])]},
    )
