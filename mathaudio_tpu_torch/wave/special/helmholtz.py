"""Helmholtz Green's function kernels (counterpart of
mathaudio_tpu/wave/special/helmholtz.py), time convention e^{-i omega t},
outgoing G = e^{ikr}/(4 pi r):

- G(x, y)            = exp(ik r) / (4 pi r),        r = |x - y|
- dG/dn_y            = (ik - 1/r) G (y-x).n_y / r     (double layer)
- dG/dn_x            = -(ik - 1/r) G (y-x).n_x / r    (adjoint double layer)
- d2G/dn_x dn_y      = [ ((ik)^2 - 3ik/r + 3/r^2)(r.n_x)(r.n_y)/r^2
                         - (ik - 1/r)(n_x.n_y)/r ] G  (hypersingular)

All functions broadcast over leading batch dimensions; points have a
trailing dimension 3; the r -> 0 singularity is +inf. Inputs that are not
tensors go to ``dtype`` (default float32) on ``device`` (default the GPU;
see ``xtypes.as_real``); further point arrays follow the first.
"""

from __future__ import annotations

import math

import torch

from mathaudio_tpu_torch.xtypes import as_real, complex_dtype_for

_PI4 = 4.0 * math.pi
_RMIN = 1e-15


def _safe_r(r):
    return torch.where(r < _RMIN, 1.0, r)


def _singular(r, value):
    """``value`` with +inf where r < _RMIN."""
    return torch.where(r < _RMIN, torch.full_like(value, math.inf), value)


def greens_function_3d(r, k, *, dtype=None, device=None):
    """G = exp(ikr)/(4 pi r)."""
    r = as_real(r, dtype, device)
    rs = _safe_r(r)
    g = torch.exp(1j * (k * rs).to(complex_dtype_for(rs.dtype))) / (_PI4 * rs)
    return _singular(r, g)


def greens_function_2d(r, k, max_arg: float = 120.0, *, dtype=None, device=None):
    """G = (i/4) H_0^(1)(kr)."""
    from mathaudio_tpu_torch.wave.special.bessel import hankel1_all

    r = as_real(r, dtype, device)
    rs = _safe_r(r)
    h0 = hankel1_all(0, k * rs, max_arg=max_arg)[0]
    return _singular(r, 0.25j * h0)


def _r_vec(source, field, dtype, device):
    source = as_real(source, dtype, device)
    field = as_real(field, source.dtype, source.device)
    rv = field - source
    r2 = torch.sum(rv * rv, dim=-1)
    return rv, torch.sqrt(r2), r2


def greens_function_gradient_3d(source, field, k, *, dtype=None, device=None):
    """grad_y G = (ik - 1/r) G (y-x)/r, trailing axis 3."""
    rv, r, _ = _r_vec(source, field, dtype, device)
    g = greens_function_3d(r, k)
    factor = (1j * k - 1.0 / _safe_r(r)) * g
    return factor[..., None] * rv / _safe_r(r)[..., None]


def greens_function_normal_derivative_3d(source, field, normal_field, k, *, dtype=None,
                                         device=None):
    """dG/dn_y = (ik - 1/r) G (y-x).n_y / r."""
    rv, r, _ = _r_vec(source, field, dtype, device)
    g = greens_function_3d(r, k)
    r_dot_n = torch.sum(rv * as_real(normal_field, rv.dtype, rv.device), dim=-1)
    return (1j * k - 1.0 / _safe_r(r)) * g * r_dot_n / _safe_r(r)


def greens_function_adjoint_derivative_3d(source, field, normal_source, k, *, dtype=None,
                                          device=None):
    """dG/dn_x = (1/r - ik) G (y-x).n_x / r."""
    rv, r, _ = _r_vec(source, field, dtype, device)
    g = greens_function_3d(r, k)
    r_dot_n = torch.sum(rv * as_real(normal_source, rv.dtype, rv.device), dim=-1)
    return (1.0 / _safe_r(r) - 1j * k) * g * r_dot_n / _safe_r(r)


def greens_function_hypersingular_3d(source, field, normal_source, normal_field, k, *,
                                     dtype=None, device=None):
    """d2G/(dn_x dn_y)."""
    rv, r, r2 = _r_vec(source, field, dtype, device)
    rs, r2s = _safe_r(r), _safe_r(r2)
    g = greens_function_3d(r, k)
    ik = 1j * k
    nx = as_real(normal_source, rv.dtype, rv.device)
    ny = as_real(normal_field, rv.dtype, rv.device)
    r_dot_nx = torch.sum(rv * nx, dim=-1)
    r_dot_ny = torch.sum(rv * ny, dim=-1)
    nx_dot_ny = torch.sum(nx * ny, dim=-1)
    coef1 = ik * ik - 3.0 * ik / rs + 3.0 / r2s
    term1 = coef1 * r_dot_nx * r_dot_ny / r2s
    term2 = (ik - 1.0 / rs) * nx_dot_ny / rs
    return (term1 - term2) * g


def all_kernels_3d(source, field, normal_source, normal_field, k, *, dtype=None, device=None):
    """Fused (G, dG/dn_y, dG/dn_x, d2G/dn_x dn_y): one r/exp evaluation
    shared by all four kernels, broadcast over any (collocation x
    quadrature-point) batch shape."""
    rv, r, r2 = _r_vec(source, field, dtype, device)
    rs, r2s = _safe_r(r), _safe_r(r2)
    cdtype = complex_dtype_for(rs.dtype)
    g = torch.exp(1j * (k * rs).to(cdtype)) / (_PI4 * rs)

    nx = as_real(normal_source, rv.dtype, rv.device)
    ny = as_real(normal_field, rv.dtype, rv.device)
    r_dot_nx = torch.sum(rv * nx, dim=-1)
    r_dot_ny = torch.sum(rv * ny, dim=-1)
    nx_dot_ny = torch.sum(nx * ny, dim=-1)

    ik = torch.tensor(1j * k, dtype=cdtype, device=rv.device)
    factor_dg = ik - 1.0 / rs
    dg_dny = factor_dg * g * r_dot_ny / rs
    dg_dnx = -factor_dg * g * r_dot_nx / rs
    coef1 = ik * ik - 3.0 * ik / rs + 3.0 / r2s
    d2g = (coef1 * r_dot_nx * r_dot_ny / r2s - factor_dg * nx_dot_ny / rs) * g
    return g, dg_dny, dg_dnx, d2g


def laplace_greens_function_3d(r, *, dtype=None, device=None):
    """k = 0 limit: 1/(4 pi r)."""
    r = as_real(r, dtype, device)
    return _singular(r, 1.0 / (_PI4 * _safe_r(r)))


def laplace_greens_function_2d(r, *, dtype=None, device=None):
    """-ln(r)/(2 pi)."""
    r = as_real(r, dtype, device)
    return _singular(r, -torch.log(_safe_r(r)) / (2.0 * math.pi))
