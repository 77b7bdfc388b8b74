"""Vector helpers (counterpart of mathaudio_tpu/solvers/blas.py).

The complex-aware inner product is conjugate-linear in its first argument
(BLAS zdotc); each helper is one or two torch ops on the vectors' device.
"""

from __future__ import annotations

import torch


def inner_product(x, y):
    """<x, y> = sum conj(x) * y."""
    return torch.sum(torch.conj(x) * y)


def vector_norm(x):
    """||x||_2 as a real scalar (safe for complex x)."""
    return torch.sqrt(torch.sum(torch.abs(x) ** 2))


def axpy(alpha, x, y):
    """y + alpha x."""
    return alpha * x + y


def axpby(alpha, x, beta, y):
    return alpha * x + beta * y
