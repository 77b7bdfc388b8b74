"""Differentiable biquad responses (counterpart of
mathaudio_tpu/dsp/jax_response.py; renamed, as nothing here is JAX).

RBJ coefficients and magnitude response as tensor functions of
(f0, Q, gain), so filter parameters can be optimization variables (the
speaker-EQ fitting path: DE over PEQ parameters against a target SPL,
driving dsp + optim together). Same math as dsp.iir.Biquad, but
differentiable by autograd and batched: parameters may carry leading
axes (a population), which broadcast against the frequency grid, and the
functions run under ``torch.func.vmap``.

Host Biquad objects remain the API for fixed filters.
"""

from __future__ import annotations

import math

import torch

from mathaudio_tpu_torch.dsp.iir import SRATE, as_tensor


def _tensors(*vals, like=None, device=None):
    """Each value as a tensor: tensors kept, the others on the device and
    dtype of ``like`` or of the first tensor among them (float64 on
    ``device`` when there is none)."""
    if like is None:
        like = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    if like is None:
        like = as_tensor(0.0, device)
    return [v if isinstance(v, torch.Tensor) else
            torch.as_tensor(v, dtype=like.dtype, device=like.device) for v in vals]


def _response_db_from_coeffs(b0, b1, b2, a1, a2, freqs, srate):
    phi = torch.sin(math.pi * freqs / srate) ** 2
    phi2 = phi * phi
    r_up = (
        (b0 + b1 + b2) ** 2
        - 4.0 * (b0 * b1 + 4.0 * b0 * b2 + b1 * b2) * phi
        + 16.0 * b0 * b2 * phi2
    )
    r_dw = (
        (1.0 + a1 + a2) ** 2
        - 4.0 * (a1 + 4.0 * a2 + a1 * a2) * phi
        + 16.0 * a2 * phi2
    )
    return 10.0 * torch.log10(torch.clamp_min(r_up / r_dw, 1e-20))


def peak_coeffs(f0, q, gain_db, srate=SRATE, *, device=None):
    f0, q, gain_db = _tensors(f0, q, gain_db, device=device)
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * f0 / srate
    alpha = torch.sin(w0) / (2.0 * q)
    cs = torch.cos(w0)
    a0 = 1.0 + alpha / a
    return (
        (1.0 + alpha * a) / a0, -2.0 * cs / a0, (1.0 - alpha * a) / a0,
        -2.0 * cs / a0, (1.0 - alpha / a) / a0,
    )


def lowshelf_coeffs(f0, q, gain_db, srate=SRATE, *, device=None):
    f0, q, gain_db = _tensors(f0, q, gain_db, device=device)
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * f0 / srate
    sn, cs = torch.sin(w0), torch.cos(w0)
    beta = torch.sqrt(a + a)
    b0 = a * ((a + 1) - (a - 1) * cs + beta * sn)
    b1 = 2 * a * ((a - 1) - (a + 1) * cs)
    b2 = a * ((a + 1) - (a - 1) * cs - beta * sn)
    a0 = (a + 1) + (a - 1) * cs + beta * sn
    a1 = -2 * ((a - 1) + (a + 1) * cs)
    a2 = (a + 1) + (a - 1) * cs - beta * sn
    return b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0


def highshelf_coeffs(f0, q, gain_db, srate=SRATE, *, device=None):
    f0, q, gain_db = _tensors(f0, q, gain_db, device=device)
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * f0 / srate
    sn, cs = torch.sin(w0), torch.cos(w0)
    beta = torch.sqrt(a + a)
    b0 = a * ((a + 1) + (a - 1) * cs + beta * sn)
    b1 = -2 * a * ((a - 1) + (a + 1) * cs)
    b2 = a * ((a + 1) + (a - 1) * cs - beta * sn)
    a0 = (a + 1) - (a - 1) * cs + beta * sn
    a1 = 2 * ((a - 1) - (a + 1) * cs)
    a2 = (a + 1) - (a - 1) * cs - beta * sn
    return b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0


_COEFF_FNS = {"PK": peak_coeffs, "LS": lowshelf_coeffs, "HS": highshelf_coeffs}


def biquad_response_db(kind: str, f0, q, gain_db, freqs, srate=SRATE, *, device=None):
    """dB magnitude response of one parametric filter at ``freqs``."""
    freqs = as_tensor(freqs, device)
    f0, q, gain_db = _tensors(f0, q, gain_db, like=freqs)
    b0, b1, b2, a1, a2 = _COEFF_FNS[kind](f0, q, gain_db, srate)
    return _response_db_from_coeffs(b0, b1, b2, a1, a2, freqs, srate)


def peq_response_db(kinds, params, freqs, srate=SRATE, *, device=None):
    """Total dB response of a parametric EQ.

    kinds: static list of filter kinds ('PK'/'LS'/'HS'); params: (..., n, 3)
    of (log10 f0, Q, gain_dB), any leading axes batched — log-frequency
    parametrization keeps DE search spaces well-scaled. Returns
    (..., len(freqs))."""
    freqs = as_tensor(freqs, device)
    params = _tensors(params, like=freqs)[0]
    total = torch.zeros(params.shape[:-2] + freqs.shape, dtype=freqs.dtype, device=freqs.device)
    for i, kind in enumerate(kinds):
        f0 = 10.0 ** params[..., i, 0, None]
        total = total + biquad_response_db(
            kind, f0, params[..., i, 1, None], params[..., i, 2, None], freqs, srate)
    return total
