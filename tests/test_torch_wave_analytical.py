"""Port vs reference: the analytical solutions (wave/analytical), on the
special functions that test_torch_wave.py holds to the reference.

The same numpy inputs go through the JAX functions (CPU, x64, as the
conftest sets them) and the port's on the CPU in float64: the analytical
solutions agree to 1e-10. The port's float32 Mie oracle stays finite where
the reference's float32 form returns NaN (orders 19 and up overflow y_n at
ka = 0.1, 36 and up at ka = 2) and agrees with its float64 form to 1e-4 at
ka 0.1, 2 and 5 with 40 terms. Each JAX call here retraces and compiles its
scans (seconds each), so the cases are few.
"""

import numpy as np
import pytest
import torch

import mathaudio_tpu.wave.analytical as jax_analytical
import mathaudio_tpu_torch.wave.analytical as analytical
from mathaudio_tpu.wave.analytical import solutions_3d as jax_solutions_3d
from mathaudio_tpu.wave.analytical.solutions_2d import classify_regime_2d as jax_classify_regime_2d
from mathaudio_tpu_torch.wave.analytical import solutions_3d
from mathaudio_tpu_torch.wave.analytical.solutions_2d import classify_regime_2d
from test_torch_wave import CPU64, _close, _np, _one_torch_thread  # noqa: F401


# name: call of (the analytical package, its solutions_3d module, keywords): the
# port's with dtype/device, the reference's with none
ANALYTICAL = {
    "plane_wave_1d": lambda m, m3, kw: m.plane_wave_1d(1.3, -0.5, 2 * np.pi, 40, **kw),
    "standing_wave_1d": lambda m, m3, kw: m.standing_wave_1d(2.0, 0.0, np.pi, 51, **kw),
    "damped_wave_1d": lambda m, m3, kw: m.damped_wave_1d(1.0, 0.1, 0.0, 10.0, 33, **kw),
    "helmholtz_1d_mode": lambda m, m3, kw: m.helmholtz_1d_mode(2.0, 1.0, 2, 25, **kw),
    "cylinder_scattering_2d": lambda m, m3, kw: m.cylinder_scattering_2d(
        2.0, 1.0, 30, [1.0, 1.5, 3.0], np.linspace(-np.pi, np.pi, 13), **kw),
    "plane_wave_2d": lambda m, m3, kw: m.plane_wave_2d(1.5, np.pi / 4, np.linspace(0, 1, 4),
                                                   np.linspace(-1, 0, 3), **kw),
    "sphere_scattering_3d": lambda m, m3, kw: m.sphere_scattering_3d(
        2.0, 1.0, 40, [1.0, 1.3, 3.0], np.linspace(0, np.pi, 11), **kw),
    "plane_wave_3d": lambda m, m3, kw: m.plane_wave_3d(
        2.0, 0.7, -0.4, np.random.default_rng(1).normal(size=(6, 3)), **kw),
    "point_source_3d": lambda m, m3, kw: m.point_source_3d(
        2.0, np.array([0.1, 0.0, -0.2]), np.random.default_rng(2).normal(size=(6, 3)), **kw),
    "pulsating_sphere_3d": lambda m, m3, kw: m3.pulsating_sphere_3d(
        1.4, 1.0, np.random.default_rng(4).normal(size=(8, 3)) * 3, 0.5 - 0.2j, **kw),
    "impedance_sphere_3d": lambda m, m3, kw: m3.impedance_sphere_3d(
        0.9, 1.0, np.random.default_rng(5).normal(size=(8, 3)) * 3, 1.0, 0.3 + 0.1j, **kw),
}


@pytest.mark.parametrize("name", list(ANALYTICAL))
def test_analytical_solution_matches_reference(name):
    ref = ANALYTICAL[name](jax_analytical, jax_solutions_3d, {})
    got = ANALYTICAL[name](analytical, solutions_3d, CPU64)
    assert got.pressure.dtype == torch.complex128 and got.positions.dtype == torch.float64
    assert (got.name, got.dimensions, got.metadata) == (ref.name, ref.dimensions, ref.metadata)
    assert got.wave_number == ref.wave_number and abs(got.frequency - ref.frequency) < 1e-12
    _close(got.positions, ref.positions, 1e-12, atol=1e-15)
    _close(got.pressure, ref.pressure, 0.0, atol=1e-10 * np.abs(_np(ref.pressure)).max())
    scale = np.abs(_np(ref.pressure)).max()
    for method in ("magnitude", "real", "imag"):
        np.testing.assert_allclose(_np(getattr(got, method)()), _np(getattr(ref, method)()),
                                   rtol=0.0, atol=1e-10 * scale)
    away = np.abs(_np(ref.pressure)) > 1e-6 * scale  # the phase of a zero is its sign bits
    np.testing.assert_allclose(_np(got.phase())[away], _np(ref.phase())[away], rtol=0.0, atol=1e-10)


def test_coefficients_and_cross_sections_match_reference():
    for ka in (0.1, 5.0):
        _close(analytical.rigid_sphere_coefficients(ka, 40, **CPU64),
               jax_analytical.rigid_sphere_coefficients(ka, 40), 1e-10)
    pts = np.random.default_rng(6).normal(size=(9, 3)) * 2.0
    _close(analytical.sphere_scattered_pressure_3d(1.5, 1.0, 30, pts, **CPU64),
           jax_analytical.sphere_scattered_pressure_3d(1.5, 1.0, 30, pts), 1e-10)
    got = analytical.sphere_scattering_efficiency_3d(20.0, 1.0, 40, **CPU64)
    ref = jax_analytical.sphere_scattering_efficiency_3d(20.0, 1.0, 40)
    assert abs(float(got) - float(ref)) <= 1e-10 * abs(float(ref))
    for ka in (0.1, 1.0, 10.0):
        assert analytical.classify_regime(ka) == jax_analytical.classify_regime(ka)
        assert classify_regime_2d(ka) == jax_classify_regime_2d(ka)


def test_error_metrics_and_coordinates_match_reference():
    rng = np.random.default_rng(7)
    p = rng.normal(size=12) + 1j * rng.normal(size=12)
    q = p + 1e-3 * (rng.normal(size=12) + 1j * rng.normal(size=12))
    for name in ("l2_error", "relative_l2_error", "linf_error"):
        got = getattr(analytical, name)(torch.tensor(p), torch.tensor(q))
        assert abs(float(got) - float(getattr(jax_analytical, name)(p, q))) < 1e-14
    assert float(analytical.relative_l2_error(torch.tensor(p), torch.zeros(12, dtype=torch.complex128))) \
        == float(jax_analytical.relative_l2_error(p, np.zeros(12, complex)))
    r, th, ph = rng.uniform(0.5, 2, 5), rng.uniform(0, np.pi, 5), rng.uniform(-np.pi, np.pi, 5)
    _close(analytical.from_spherical(r, th, ph, **CPU64), jax_analytical.from_spherical(r, th, ph),
           1e-14)
    _close(analytical.from_polar(r, th, **CPU64), jax_analytical.from_polar(r, th), 1e-14)
    a = analytical.plane_wave_1d(1.0, 0.0, 1.0, 10, **CPU64)
    assert float(a.relative_l2_error(a)) == 0.0 and float(a.l2_error(a)) == 0.0


def test_helmholtz_mode_refuses_what_the_reference_asserts():
    with pytest.raises(ValueError, match="resonance"):
        analytical.helmholtz_1d_mode(np.pi, 1.0, 1, 5, **CPU64)
    with pytest.raises(ValueError, match="mode_number"):
        analytical.helmholtz_1d_mode(2.0, 1.0, 0, 5, **CPU64)


@pytest.mark.parametrize("ka", [0.1, 2.0, 5.0])
def test_float32_mie_oracle_is_finite_where_the_reference_returns_nan(ka):
    theta = np.arccos(np.linspace(1.0, -1.0, 64))
    f64 = analytical.sphere_scattering_3d(ka, 1.0, 40, [1.0], theta, **CPU64).pressure.numpy()
    f32 = analytical.sphere_scattering_3d(ka, 1.0, 40, [1.0], theta, dtype=torch.float32,
                                          device="cpu").pressure
    assert f32.dtype == torch.complex64 and bool(torch.isfinite(f32).all())
    assert np.abs(f32.numpy() - f64).max() <= 1e-4 * np.abs(f64).max()
    coef = analytical.rigid_sphere_coefficients(ka, 40, dtype=torch.float32, device="cpu")
    assert bool(torch.isfinite(coef).all())
