"""Krylov solver configuration and the complex Givens rotation
(counterpart of mathaudio_tpu/solvers/krylov.py:32-47, 201-215)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class KrylovConfig(NamedTuple):
    """Solver configuration."""

    max_iterations: int = 1000
    tolerance: float = 1e-8
    restart: int = 30  # GMRES only
    atol: float = 0.0


class KrylovSolution(NamedTuple):
    """Solution + convergence info."""

    x: torch.Tensor
    iterations: torch.Tensor  # int32
    residual_norm: torch.Tensor  # real
    converged: torch.Tensor  # bool


def _givens(a, b):
    """Complex Givens rotation zeroing b against a (LAPACK clartg-style),
    elementwise over lanes.

    Returns (c, s, r) with c real >= 0 such that
    [c, s; -conj(s), c] @ [a; b] = [r; 0]."""
    abs_a = torch.abs(a)
    abs_b = torch.abs(b)
    t = torch.sqrt(abs_a**2 + abs_b**2)
    safe_t = torch.where(t > 0, t, 1.0)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    phase = torch.where(abs_a > 0, a / torch.where(abs_a > 0, abs_a, 1.0), one)
    c = torch.where(t > 0, abs_a / safe_t, 1.0)
    s = torch.where(t > 0, phase * torch.conj(b) / safe_t, zero)
    r = phase * t
    return c, s, r
