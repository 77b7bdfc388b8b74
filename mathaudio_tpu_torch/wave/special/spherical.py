"""Spherical Bessel j_n, y_n and spherical Hankel h_n^(1) (counterpart of
mathaudio_tpu/wave/special/spherical.py). j_n uses Miller's downward
recurrence, normalized with the exact identity
``sum_n (2n+1) j_n(x)^2 = 1`` (no zeros, unlike j_0 = sin(x)/x); y_n the
stable upward recurrence. All-order stacked outputs, shape
(nmax+1, *x.shape). Inputs that are not tensors go to ``dtype`` (default
float32) on ``device`` (default the GPU; see ``xtypes.as_real``).
"""

from __future__ import annotations

import math

import torch

from mathaudio_tpu_torch.wave.special.bessel import _miller_downward, _orders_shape
from mathaudio_tpu_torch.xtypes import as_real


def spherical_jn_all(nmax: int, x, max_arg: float = 120.0, *, dtype=None, device=None):
    """j_n(x) for n = 0..nmax, shape (nmax+1, *x.shape)."""
    x = as_real(x, dtype, device)

    # Spherical recurrence: f_{k-1} = ((2k+1)/x) f_k - f_{k+1}.
    rel = _miller_downward(nmax, x, max_arg, coeff_offset=1.0)
    orders = torch.arange(rel.shape[0], dtype=x.dtype, device=x.device)
    w = _orders_shape(2.0 * orders + 1.0, x)
    # sum (2n+1) j_n^2 = 1 -> positive-definite normalization. The identity
    # is scale-invariant, so pre-scale by the per-point max to keep the
    # squares finite (|rel| can reach the renormalization bound).
    scale = torch.amax(torch.abs(rel), dim=0)
    rel = rel / torch.where(scale < 1e-300, 1.0, scale)
    norm = torch.sqrt(torch.sum(w * rel * rel, dim=0))
    # Miller's seed is positive and j_M(x) > 0 for x below j_M's first
    # zero (M > 1.2 max_arg >= x), so the scale is positive.
    j_all = (rel / norm)[: nmax + 1]

    tiny_x = torch.abs(x) < 1e-30
    ob = _orders_shape(torch.arange(nmax + 1, device=x.device), x)
    return torch.where(tiny_x[None], (ob == 0).to(x.dtype), j_all)


def spherical_yn_all(nmax: int, x, *, dtype=None, device=None):
    """y_n(x) for n = 0..nmax via the stable upward recurrence."""
    x = as_real(x, dtype, device)
    safe_x = torch.where(torch.abs(x) < 1e-30, 1.0, x)
    y0 = -torch.cos(safe_x) / safe_x
    ys = [y0]
    if nmax > 0:
        y1 = -torch.cos(safe_x) / safe_x**2 - torch.sin(safe_x) / safe_x
        ys.append(y1)
        y_nm1, y_n = y0, y1
        for n in range(1, nmax):
            # y_{n+1} = ((2n+1)/x) y_n - y_{n-1}
            y_nm1, y_n = y_n, (2.0 * n + 1.0) / safe_x * y_n - y_nm1
            ys.append(y_n)
    tiny_x = torch.abs(x) < 1e-30
    return torch.where(tiny_x[None], -math.inf, torch.stack(ys))


def spherical_jn_yn_all(nmax: int, x, max_arg: float = 120.0, *, dtype=None, device=None):
    x = as_real(x, dtype, device)
    return spherical_jn_all(nmax, x, max_arg=max_arg), spherical_yn_all(nmax, x)


def spherical_hankel1_all(nmax: int, x, max_arg: float = 120.0, *, dtype=None, device=None):
    """h_n^(1)(x) = j_n(x) + i y_n(x)."""
    j_all, y_all = spherical_jn_yn_all(nmax, x, max_arg=max_arg, dtype=dtype, device=device)
    return torch.complex(j_all, y_all)


def spherical_bessel_derivative(f_all, x):
    """f_n'(x) = f_{n-1}(x) - ((n+1)/x) f_n(x) for stacked spherical
    Bessel-family values; order 0 uses f_0' = -f_1. Works for j, y, h.
    ``x`` goes to the real dtype and device of ``f_all``."""
    real = f_all.real.dtype if f_all.is_complex() else f_all.dtype
    x = as_real(x, real, f_all.device)
    safe_x = torch.where(torch.abs(x) < 1e-30, 1.0, x)
    n = _orders_shape(torch.arange(f_all.shape[0], dtype=real, device=x.device), x)
    d_rest = f_all[:-1] - ((n[1:] + 1.0) / safe_x) * f_all[1:]
    return torch.cat([-f_all[1][None], d_rest], dim=0)
