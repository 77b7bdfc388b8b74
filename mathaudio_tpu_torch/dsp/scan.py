"""Biquad filtering as a log-depth scan (counterpart of
mathaudio_tpu/dsp/scan.py).

The Direct-Form-I recurrence (iir.rs:324-341)

    y[n] = d[n] - a1 y[n-1] - a2 y[n-2],
    d[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2]

is scanned by the JAX package as ``jax.lax.associative_scan`` over 2x2
affine maps on the state (y[n], y[n-1]). Here the all-pole part is
factored at its poles p1, p2 (the roots of z^2 + a1 z + a2) into two
first-order recursions in series,

    w[n] = p1 w[n-1] + d[n],   y[n] = p2 y[n-1] + w[n],

each a doubling (Hillis-Steele) scan w[n] += p^h w[n-h] over one (..., T)
plane, with p^h a host scalar: ceil(log2 T) passes each, no (T, 2, 2)
array. Complex-conjugate poles run in the complex dtype and y is the real
part. Why not the 2x2 state: for the low, resonant stages of a PEQ the
powers A^h have entries near 1/sin(arg p) and the log-depth sum loses
that factor squared in float32 (1e-2 of max|y| at 100 Hz, Q 1), where
|p^h| <= 1 keeps each first-order scan as accurate as the sequential
recurrence. Time is the last axis; any leading axes are channels that
share the coefficients (what ``jax.vmap`` over x gives the reference).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mathaudio_tpu_torch.dsp.iir import as_tensor
from mathaudio_tpu_torch.xtypes import complex_dtype_for


def _host_coeffs(coeffs, dtype):
    """The coefficients rounded to ``dtype`` (the reference casts them to
    x's dtype), as host floats: the scan's multipliers are scalars."""
    vals = [float(c) for c in coeffs]
    return torch.tensor(vals, dtype=dtype).tolist()


def _poles(a1, a2):
    """Roots of z^2 + a1 z + a2: a complex-conjugate pair, or two reals
    (the larger-magnitude root first, the other from the product a2)."""
    disc = a1 * a1 - 4.0 * a2
    if disc < 0.0:
        p = complex(-0.5 * a1, 0.5 * math.sqrt(-disc))
        return p, p.conjugate()
    q = -0.5 * (a1 + math.copysign(math.sqrt(disc), a1))
    return (q, a2 / q) if q != 0.0 else (0.0, 0.0)


def _first_order_scan(g, p):
    """w[n] = p w[n-1] + g[n] from w[-1] = 0, along the last axis, by
    doubling: after the pass of stride h each w[n] sums the last 2h terms."""
    t = g.shape[-1]
    h, p_h = 1, p
    while h < t and p_h != 0:
        w = torch.empty_like(g)
        w[..., :h] = g[..., :h]
        torch.add(g[..., h:], g[..., :-h], alpha=p_h, out=w[..., h:])
        g, h, p_h = w, 2 * h, p_h * p_h
    return g


def _state(state, x):
    lead = x.shape[:-1]
    if state is None:
        return None
    return tuple(torch.as_tensor(s, dtype=x.dtype, device=x.device).expand(lead) for s in state)


def biquad_process_block(x, coeffs, state=None):
    """Filter a block through one biquad; time on the last axis.

    coeffs: (b0, b1, b2, a1, a2); state: (x1, x2, y1, y2) or None, each a
    scalar or a tensor of x's leading shape. Returns (y, new_state) with the
    semantics of the reference's Direct Form I process_block (iir.rs:341);
    for a 1-D block new_state is a tuple of 0-d tensors."""
    b0, b1, b2, a1, a2 = _host_coeffs(coeffs, x.dtype)
    st = _state(state, x)
    t = x.shape[-1]

    # feedforward with the carried (x1, x2); length t also for t < 2
    d = b0 * x
    d[..., 1:].add_(x[..., :-1], alpha=b1)
    if st is not None:
        x1, x2, y1, y2 = st
        d[..., 0] += b1 * x1
        d[..., 0] += b2 * x2
        if t >= 2:
            d[..., 1] += b2 * x1
    d[..., 2:].add_(x[..., :-2], alpha=b2)

    p1, p2 = _poles(a1, a2)
    if isinstance(p1, complex):
        d = d.to(complex_dtype_for(x.dtype))
    if st is not None:
        # the carried (y1, y2) as w[-1] = y1 - p2 y2 and y[-1] = y1
        d[..., 0] += p1 * (y1 - p2 * y2)
    w = _first_order_scan(d, p1)
    if st is not None:
        w[..., 0] += p2 * y1
    y = _first_order_scan(w, p2)
    if y.is_complex():
        y = y.real.contiguous()

    if st is None:
        x1 = y1 = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    new_state = (
        x[..., -1],
        x[..., -2] if t >= 2 else x1,
        y[..., -1],
        y[..., -2] if t >= 2 else y1,
    )
    return y, new_state


def peq_coeff_matrix(peq, dtype=torch.float32, *, device=None):
    """Stack a Peq's biquad coefficients into (S, 5) [b0 b1 b2 a1 a2]
    (weights are applied in the dB domain by response functions; for
    sample processing all stages run in series like the reference)."""
    rows = [(bq.b0, bq.b1, bq.b2, bq.a1, bq.a2) for _, bq in peq]
    return as_tensor(np.asarray(rows), device).to(dtype)


def biquad_cascade_block(x, coeff_matrix):
    """Run a (S, 5) cascade over a block; stages in series, each one scan
    from zero state."""
    rows = coeff_matrix.tolist() if isinstance(coeff_matrix, torch.Tensor) else (
        np.asarray(coeff_matrix).tolist())
    y = x
    for cf in rows:
        y, _ = biquad_process_block(y, cf)
    return y
