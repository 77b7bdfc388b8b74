"""Port vs reference: the special functions (wave/special) and the xtypes
helpers they sit on; the analytical solutions built on them are in
test_torch_wave_analytical.py (a file of its own, so that a parallel test
run takes the two at once).

The same numpy inputs go through the JAX functions (CPU, x64, as the
conftest sets them) and the port's on the CPU in float64: the special
functions at the orders and arguments of tests/test_wave_special.py agree
to 1e-12 relative. Each JAX call here retraces and compiles its scans
(seconds each; eagerly, under ``jax.disable_jit``, 5-10 times longer), so
the cases are few.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mathaudio_tpu.wave.special as jax_special
import mathaudio_tpu.xtypes as jax_xtypes
import mathaudio_tpu_torch.wave.analytical as analytical
import mathaudio_tpu_torch.wave.special as special
import mathaudio_tpu_torch.xtypes as xtypes
from mathaudio_tpu.wave.special.bessel import bessel_derivative_all as jax_bessel_derivative_all
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


def test_inputs_take_the_default_float_and_stay_on_their_device():
    x = special.spherical_jn_all(3, [0.5, 1.0], device="cpu")
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert special.legendre_all(2, torch.tensor([0.5], dtype=torch.float64)).dtype == torch.float64
    sol = analytical.sphere_scattering_3d(1.0, 1.0, 10, [2.0], [0.3], device="cpu")
    assert sol.pressure.dtype == torch.complex64
