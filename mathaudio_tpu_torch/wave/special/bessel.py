"""Cylindrical Bessel functions J_n, Y_n and Hankel H_n^(1) (counterpart of
mathaudio_tpu/wave/special/bessel.py), all orders at once, stacked
``(nmax+1, *x.shape)``:

- J_n via Miller's downward recurrence with renormalization (the scale
  carried as a log so small x does not overflow), normalized by the
  Neumann identity  J_0 + 2*sum_{k>=1} J_{2k} = 1. The reference runs the
  recurrence as a ``lax.scan``; here it is a loop over orders, each step
  one elementwise pass over x.
- Y_0, Y_1 via the exact Neumann log-series built from the J_n array,
  then the (stable) upward recurrence for Y_n.

Valid for 0 <= x <= ``max_arg`` (it sets the recurrence length). Inputs
that are not tensors go to ``dtype`` (default float32) on ``device``
(default the GPU; see ``xtypes.as_real``).
"""

from __future__ import annotations

import math

import torch

from mathaudio_tpu_torch.xtypes import as_real

EULER_GAMMA = 0.5772156649015329


def _orders_shape(values, x):
    """(M,) values shaped to broadcast against (M, *x.shape)."""
    return values.reshape((-1,) + (1,) * x.ndim)


def _miller_downward(nmax: int, x, max_arg: float, coeff_offset: float = 0.0):
    """Unnormalized downward recurrence values f_k, k = 0..M, as
    ``rel[k] = f_k * exp(g_k - g_0)``: true values relative to order 0's
    scale, safe against overflow. Returns rel with shape (M+1, *x.shape).

    The recurrence F_{k-1} = (2k/x) F_k - F_{k+1} is shared by J_n and
    spherical j_n (with 2k -> 2k+1), so the coefficient is a parameter.
    """
    dtype = x.dtype
    big = 1e250 if dtype == torch.float64 else 1e30
    log_big = math.log(big)

    m_start = nmax + int(1.2 * max_arg) + 22
    safe_x = torch.where(torch.abs(x) < 1e-30, 1.0, x)
    inv_x = 1.0 / safe_x

    seed = torch.full_like(x, 1e-30)
    zero = torch.zeros_like(x)
    f_k, f_k1, g = seed, zero, zero
    fs, gs = [seed], [zero]  # order M first
    for k in range(m_start, 0, -1):
        f_km1 = (2.0 * k + coeff_offset) * inv_x * f_k - f_k1
        over = torch.abs(f_km1) > big
        scale = torch.ones_like(x).masked_fill_(over, 1.0 / big)
        f_km1 = f_km1 * scale
        f_k = f_k * scale
        g = g + over.to(dtype) * log_big
        f_k, f_k1 = f_km1, f_k
        fs.append(f_km1)
        gs.append(g)
    fs = torch.stack(fs[::-1])  # orders 0..M
    gs = torch.stack(gs[::-1])
    return fs * torch.exp(gs - gs[0])  # g_0 is the largest scale: exponents <= 0


def bessel_jn_all(nmax: int, x, max_arg: float = 120.0, *, dtype=None, device=None):
    """J_n(x) for n = 0..nmax, shape (nmax+1, *x.shape)."""
    return bessel_jn_yn_all(nmax, x, max_arg=max_arg, with_y=False, dtype=dtype, device=device)[0]


def bessel_jn_yn_all(nmax: int, x, max_arg: float = 120.0, with_y: bool = True, *, dtype=None,
                     device=None):
    """(J_n(x), Y_n(x)) for n = 0..nmax, each shape (nmax+1, *x.shape).

    ``max_arg`` must bound max(|x|); it fixes the recurrence length.
    """
    x = as_real(x, dtype, device)
    rdt = x.dtype

    rel = _miller_downward(nmax, x, max_arg)  # orders 0..M
    m_total = rel.shape[0] - 1

    # Neumann normalization: J_0 + 2 sum_{k>=1} J_{2k} = 1.
    orders = torch.arange(m_total + 1, device=x.device)
    even_w = torch.where(orders == 0, 1.0, torch.where(orders % 2 == 0, 2.0, 0.0)).to(rdt)
    norm = torch.tensordot(even_w, rel, dims=1)
    j_all_full = rel / norm

    tiny_x = torch.abs(x) < 1e-30
    orders_b = _orders_shape(orders, x)
    j_all_full = torch.where(tiny_x[None], (orders_b == 0).to(rdt), j_all_full)
    j_all = j_all_full[: nmax + 1]
    if not with_y:
        return j_all, None

    # Y_0 via the exact Neumann log-series:
    #   Y_0 = (2/pi) [ (ln(x/2) + gamma) J_0 - 2 sum_{k>=1} (-1)^k J_{2k} / k ]
    safe_x = torch.where(tiny_x, 1.0, x)
    log_term = torch.log(safe_x / 2.0) + EULER_GAMMA
    n_even = (m_total - 1) // 2  # even orders 2..2K with 2K+1 <= m_total (Y_1 needs J_{2K+1})
    k_idx = torch.arange(1, n_even + 1, dtype=rdt, device=x.device)
    j_even = j_all_full[2: 2 * n_even + 1: 2]  # J_2, J_4, ...
    alt = torch.where(torch.arange(1, n_even + 1, device=x.device) % 2 == 1, -1.0, 1.0).to(rdt)
    s0 = torch.tensordot(alt / k_idx, j_even, dims=1)
    y0 = (2.0 / math.pi) * (log_term * j_all_full[0] - 2.0 * s0)

    # Y_1 = -Y_0' expanded through the same series (d/dx of each term):
    #   Y_1 = (2/pi) [ (ln(x/2)+gamma) J_1 - J_0/x
    #                  + sum_{k>=1} (-1)^k (J_{2k-1} - J_{2k+1}) / k ]
    j_odd_lo = j_all_full[1: 2 * n_even: 2]  # J_1, J_3, ..., J_{2K-1}
    j_odd_hi = j_all_full[3: 2 * n_even + 2: 2]  # J_3, J_5, ..., J_{2K+1}
    s1 = torch.tensordot(alt / k_idx, j_odd_lo - j_odd_hi, dims=1)
    y1 = (2.0 / math.pi) * (log_term * j_all_full[1] - j_all_full[0] / safe_x + s1)

    ys = [y0]
    if nmax > 0:
        # Upward recurrence (stable for Y): Y_{n+1} = (2n/x) Y_n - Y_{n-1}.
        ys.append(y1)
        y_nm1, y_n = y0, y1
        for n in range(1, nmax):
            y_nm1, y_n = y_n, (2.0 * n) / safe_x * y_n - y_nm1
            ys.append(y_n)
    y_all = torch.where(tiny_x[None], -math.inf, torch.stack(ys))
    return j_all, y_all


def hankel1_all(nmax: int, x, max_arg: float = 120.0, *, dtype=None, device=None):
    """H_n^(1)(x) = J_n(x) + i Y_n(x), shape (nmax+1, *x.shape), complex."""
    j_all, y_all = bessel_jn_yn_all(nmax, x, max_arg=max_arg, dtype=dtype, device=device)
    return torch.complex(j_all, y_all)


def bessel_j0(x, max_arg: float = 120.0, *, dtype=None, device=None):
    return bessel_jn_all(0, x, max_arg=max_arg, dtype=dtype, device=device)[0]


def bessel_j1(x, max_arg: float = 120.0, *, dtype=None, device=None):
    return bessel_jn_all(1, x, max_arg=max_arg, dtype=dtype, device=device)[1]


def bessel_y0(x, max_arg: float = 120.0, *, dtype=None, device=None):
    return bessel_jn_yn_all(0, x, max_arg=max_arg, dtype=dtype, device=device)[1][0]


def bessel_y1(x, max_arg: float = 120.0, *, dtype=None, device=None):
    return bessel_jn_yn_all(1, x, max_arg=max_arg, dtype=dtype, device=device)[1][1]


def bessel_derivative_all(c_all, x):
    """C_n'(x) = C_{n-1}(x) - (n/x) C_n(x) for cylindrical Bessel-family
    values stacked over orders 0..nmax. Returns the same stacked shape;
    order 0 uses C_0' = -C_1. Needs nmax >= 1. ``x`` goes to the real
    dtype and device of ``c_all``."""
    real = c_all.real.dtype if c_all.is_complex() else c_all.dtype
    x = as_real(x, real, c_all.device)
    safe_x = torch.where(torch.abs(x) < 1e-30, 1.0, x)
    n = _orders_shape(torch.arange(c_all.shape[0], dtype=real, device=x.device), x)
    d_rest = c_all[:-1] - (n[1:] / safe_x) * c_all[1:]
    return torch.cat([-c_all[1][None], d_rest], dim=0)

