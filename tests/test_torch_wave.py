"""Port vs reference: the special functions and the analytical solutions
(wave/special, wave/analytical) and the xtypes helpers they sit on.

The same numpy inputs go through the JAX functions (CPU, x64, as the
conftest sets them) and the port's on the CPU in float64: the special
functions at the orders and arguments of tests/test_wave_special.py agree
to 1e-12 relative, the analytical solutions to 1e-10. The port's float32
Mie oracle stays finite where the reference's float32 form returns NaN
(orders 19 and up overflow y_n at ka = 0.1, 36 and up at ka = 2) and
agrees with its float64 form to 1e-4 at ka 0.1, 2 and 5 with 40 terms.
Each JAX call here retraces and compiles its scans (seconds each), so the
cases are few.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.wave.analytical as jax_analytical
import mathaudio_tpu.wave.special as jax_special
import mathaudio_tpu.xtypes as jax_xtypes
import mathaudio_tpu_torch.wave.analytical as analytical
import mathaudio_tpu_torch.wave.special as special
import mathaudio_tpu_torch.xtypes as xtypes
from mathaudio_tpu.wave.analytical import solutions_3d as jax_solutions_3d
from mathaudio_tpu.wave.analytical.solutions_2d import classify_regime_2d as jax_classify_regime_2d
from mathaudio_tpu.wave.special.bessel import bessel_derivative_all as jax_bessel_derivative_all
from mathaudio_tpu_torch.wave.analytical import solutions_3d
from mathaudio_tpu_torch.wave.analytical.solutions_2d import classify_regime_2d
from mathaudio_tpu_torch.wave.special.bessel import bessel_derivative_all

XS = np.array([0.05, 0.3, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 95.0])
CPU64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol, atol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _t(a):
    return torch.tensor(np.asarray(a, float))


# name: call of a special-function module: the orders and arguments of
# tests/test_wave_special.py
SPECIAL = {
    "bessel_jn_all": lambda m: m.bessel_jn_all(30, XS),
    "bessel_jn_yn_all": lambda m: m.bessel_jn_yn_all(20, XS),
    "hankel1_all": lambda m: m.hankel1_all(5, XS),
    "bessel_jn_all_small_x": lambda m: m.bessel_jn_all(40, np.array([1e-6, 1e-3])),
    "bessel_jn_all_zero": lambda m: m.bessel_jn_all(3, np.array(0.0)),
    "bessel_y1": lambda m: m.bessel_y1(XS),
    "spherical_jn_all": lambda m: m.spherical_jn_all(25, XS),
    "spherical_jn_all_zeros": lambda m: m.spherical_jn_all(
        10, np.array([np.pi, 2 * np.pi, 4.493409457909064])),
    "spherical_yn_all": lambda m: m.spherical_yn_all(15, XS),
    "spherical_jn_yn_all_wronskian_grid": lambda m: m.spherical_jn_yn_all(
        15, np.linspace(0.3, 40.0, 60)),
    "spherical_hankel1_all": lambda m: m.spherical_hankel1_all(8, XS),
    "spherical_bessel_derivative": lambda m: m.spherical_bessel_derivative(
        m.spherical_jn_all(9, XS), XS),
    "legendre_all": lambda m: m.legendre_all(12, np.linspace(-1, 1, 41)),
    "legendre_p": lambda m: m.legendre_p(7, np.linspace(-1, 1, 41)),
    "legendre_derivative_all": lambda m: m.legendre_derivative_all(
        6, np.concatenate([np.linspace(-0.95, 0.95, 21), [1.0, -1.0]])),
    "associated_legendre_all": lambda m: [m.associated_legendre_all(6, mm, np.linspace(-0.9, 0.9, 11))
                                          for mm in (0, 1, 2, 3, 7)],
    "normalized_associated_legendre_all": lambda m: [m.normalized_associated_legendre_all(
        6, mm, np.linspace(-0.9, 0.9, 11)) for mm in (0, 2, 3)],
    "greens_function_3d": lambda m: m.greens_function_3d(np.array([0.0, 0.3, 1.0, 2.0]), 2.0),
    "greens_function_2d": lambda m: m.greens_function_2d(np.array([0.3, 1.0, 2.0]), 2.0),
    "laplace_greens": lambda m: (m.laplace_greens_function_3d(np.array([0.0, 0.7])),
                                 m.laplace_greens_function_2d(np.array([0.0, 0.7]))),
}


def _port_inputs(fn):
    """``fn`` of a module whose numpy arrays become float64 CPU tensors."""

    class Port:
        def __getattr__(self, name):
            f = getattr(special, name)

            def call(*args):
                return f(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))

            return call

    return fn(Port())


def _flatten(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _flatten(o)]
    return [out]


@pytest.mark.parametrize("name", list(SPECIAL))
def test_special_function_matches_reference(name):
    call = SPECIAL[name]
    ref = _flatten(call(jax_special))
    got = _flatten(_port_inputs(call))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype in (torch.float64, torch.complex128)
        _close(g, r, 1e-12, atol=1e-15)  # atol: rounding where a function crosses 0


def test_bessel_derivative_matches_reference():
    j, y = jax_special.bessel_jn_yn_all(8, jnp.asarray(XS))
    tj, ty = special.bessel_jn_yn_all(8, _t(XS))
    for ref_c, c in ((j, tj), (y, ty), (j + 1j * y, torch.complex(tj, ty))):
        _close(bessel_derivative_all(c, _t(XS)), jax_bessel_derivative_all(ref_c, jnp.asarray(XS)),
               1e-12)


def test_kernel_family_matches_reference():
    rng = np.random.default_rng(3)
    src, fld = rng.normal(size=(5, 4, 3)), rng.normal(size=(5, 4, 3))
    nx, ny = rng.normal(size=(5, 4, 3)), rng.normal(size=(5, 4, 3))
    nx /= np.linalg.norm(nx, axis=-1, keepdims=True)
    ny /= np.linalg.norm(ny, axis=-1, keepdims=True)
    k = 1.7
    pairs = [
        (jax_special.greens_function_gradient_3d(src, fld, k),
         special.greens_function_gradient_3d(_t(src), _t(fld), k)),
        (jax_special.greens_function_normal_derivative_3d(src, fld, ny, k),
         special.greens_function_normal_derivative_3d(_t(src), _t(fld), _t(ny), k)),
        (jax_special.greens_function_adjoint_derivative_3d(src, fld, nx, k),
         special.greens_function_adjoint_derivative_3d(_t(src), _t(fld), _t(nx), k)),
        (jax_special.greens_function_hypersingular_3d(src, fld, nx, ny, k),
         special.greens_function_hypersingular_3d(_t(src), _t(fld), _t(nx), _t(ny), k)),
    ]
    pairs += list(zip(jax_special.all_kernels_3d(src, fld, nx, ny, k),
                      special.all_kernels_3d(_t(src), _t(fld), _t(nx), _t(ny), k)))
    for ref, got in pairs:
        _close(got, ref, 1e-12)


def test_xtypes_helpers_match_reference():
    assert xtypes.default_complex() == torch.complex64
    assert xtypes.is_complex(torch.ones(2, dtype=torch.complex128))
    assert not xtypes.is_complex(np.ones(2))
    assert xtypes.is_complex(1j) == bool(jax_xtypes.is_complex(1j))
    f = np.array([20.0, 343.0, 1000.0])
    _close(xtypes.wavenumber(f, **CPU64), jax_xtypes.wavenumber(f), 1e-15)
    _close(xtypes.wavenumber(f, 300.0, **CPU64), jax_xtypes.wavenumber(f, 300.0), 1e-15)
    _close(xtypes.log_space(20.0, 200.0, 7, torch.float64, device="cpu"),
           jax_xtypes.log_space(20.0, 200.0, 7, jnp.float64), 1e-14)
    _close(xtypes.lin_space(-1.0, 3.0, 9, torch.float64, device="cpu"),
           jax_xtypes.lin_space(-1.0, 3.0, 9, jnp.float64), 1e-15)
    assert xtypes.log_space(20.0, 200.0, 3, device="cpu").dtype == torch.float32


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


def test_inputs_take_the_default_float_and_stay_on_their_device():
    x = special.spherical_jn_all(3, [0.5, 1.0], device="cpu")
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert special.legendre_all(2, torch.tensor([0.5], dtype=torch.float64)).dtype == torch.float64
    sol = analytical.sphere_scattering_3d(1.0, 1.0, 10, [2.0], [0.3], device="cpu")
    assert sol.pressure.dtype == torch.complex64
