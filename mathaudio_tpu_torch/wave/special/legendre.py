"""Legendre polynomials and associated Legendre functions (counterpart of
mathaudio_tpu/wave/special/legendre.py): the same recurrences, all orders
stacked (nmax+1, *x.shape). Inputs that are not tensors go to ``dtype``
(default float32) on ``device`` (default the GPU; see ``xtypes.as_real``).
"""

from __future__ import annotations

import math

import torch

from mathaudio_tpu_torch.wave.special.bessel import _orders_shape
from mathaudio_tpu_torch.xtypes import as_real


def legendre_all(nmax: int, x, *, dtype=None, device=None):
    """P_n(x), n = 0..nmax via (n+1) P_{n+1} = (2n+1) x P_n - n P_{n-1}."""
    x = as_real(x, dtype, device)
    ps = [torch.ones_like(x)]
    if nmax > 0:
        ps.append(x)
        p_nm1, p_n = ps
        for n in range(1, nmax):
            p_nm1, p_n = p_n, ((2.0 * n + 1.0) * x * p_n - n * p_nm1) / (n + 1.0)
            ps.append(p_n)
    return torch.stack(ps)


def legendre_p(n: int, x, *, dtype=None, device=None):
    """Single-order P_n(x)."""
    return legendre_all(n, x, dtype=dtype, device=device)[n]


def legendre_derivative_all(nmax: int, x, *, dtype=None, device=None):
    """P_n'(x) via (1-x^2) P_n' = n (P_{n-1} - x P_n); endpoints via
    P_n'(+-1) = (+-1)^{n+1} n(n+1)/2."""
    x = as_real(x, dtype, device)
    p_all = legendre_all(nmax, x)
    n = _orders_shape(torch.arange(nmax + 1, dtype=x.dtype, device=x.device), x)
    one_m_x2 = 1.0 - x * x
    at_end = torch.abs(one_m_x2) < 1e-12
    safe = torch.where(at_end, 1.0, one_m_x2)
    p_prev = torch.cat([torch.zeros_like(x)[None], p_all[:-1]], dim=0)
    d_interior = n * (p_prev - x * p_all) / safe
    sign = torch.where(x >= 0.0, 1.0, torch.where(n % 2 == 1, 1.0, -1.0))
    d_end = sign * n * (n + 1.0) / 2.0
    return torch.where(at_end[None], d_end, d_interior)


def associated_legendre_all(nmax: int, m: int, x, *, dtype=None, device=None):
    """P_n^m(x) for n = 0..nmax (zero for n < m), Condon–Shortley phase.

    P_m^m = (-1)^m (2m-1)!! (1-x^2)^{m/2};
    P_{m+1}^m = x (2m+1) P_m^m;
    (n-m) P_n^m = x (2n-1) P_{n-1}^m - (n+m-1) P_{n-2}^m.
    """
    x = as_real(x, dtype, device)
    if m > nmax:
        return torch.zeros((nmax + 1,) + tuple(x.shape), dtype=x.dtype, device=x.device)

    somx2 = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    # (2m-1)!! with Condon–Shortley phase
    pmm = torch.ones_like(x)
    for i in range(1, m + 1):
        pmm = pmm * (-(2.0 * i - 1.0)) * somx2

    rows = [torch.zeros_like(x) for _ in range(m)] + [pmm]
    if nmax > m:
        pmmp1 = x * (2.0 * m + 1.0) * pmm
        rows.append(pmmp1)
        p_nm2, p_nm1 = pmm, pmmp1
        for n in range(m + 2, nmax + 1):
            p_nm2, p_nm1 = p_nm1, (x * (2.0 * n - 1.0) * p_nm1 - (n + m - 1.0) * p_nm2) / (n - m)
            rows.append(p_nm1)
    return torch.stack(rows)


def normalized_associated_legendre_all(nmax: int, m: int, x, *, dtype=None, device=None):
    """Orthonormalized: sqrt((2n+1)/(4 pi) * (n-m)!/(n+m)!) P_n^m(x)."""
    p = associated_legendre_all(nmax, m, x, dtype=dtype, device=device)
    norms = [0.0 if n < m else math.sqrt((2 * n + 1) / (4.0 * math.pi) * math.factorial(n - m)
                                         / math.factorial(n + m))
             for n in range(nmax + 1)]
    norms = torch.tensor(norms, dtype=p.dtype, device=p.device)
    return norms.reshape((-1,) + (1,) * (p.ndim - 1)) * p
