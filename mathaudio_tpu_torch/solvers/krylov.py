"""Krylov solver configuration, the complex Givens rotation and the
single-vector restarted GMRES (counterpart of
mathaudio_tpu/solvers/krylov.py:32-47, 201-215, 285-463)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mathaudio_tpu_torch.xtypes import full_f32_matmul


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


def as_matvec(a):
    """Normalize operator-ish inputs (an object with ``matvec``, a
    callable, or a 2-D tensor) to an ``x -> A x`` callable."""
    if hasattr(a, "matvec"):
        return a.matvec
    if callable(a):
        return a
    if isinstance(a, torch.Tensor) and a.dim() == 2:
        return lambda x: a @ x
    raise TypeError(f"cannot interpret {type(a)} as a linear operator")


def _givens_host(a: complex, b: complex):
    """``_givens`` on host scalars: (c, s, r)."""
    abs_a, abs_b = abs(a), abs(b)
    t = math.sqrt(abs_a**2 + abs_b**2)
    phase = a / abs_a if abs_a > 0 else 1.0 + 0.0j
    if t > 0:
        return abs_a / t, phase * b.conjugate() / t, phase * t
    return 1.0, 0.0j, phase * t


def gmres(a, b, x0=None, config: KrylovConfig = KrylovConfig(), preconditioner=None,
          axis_name=None):
    """Restarted GMRES(m) with left preconditioning for one right-hand
    side ``b`` (N,).

    ``a`` and ``preconditioner`` are 2-D tensors, callables or objects
    with ``matvec``. Arnoldi by twice-iterated classical Gram-Schmidt
    (two matrix-vector products with the basis per pass), Givens-rotation
    least squares, relative-residual stopping on the Givens estimate of
    the preconditioned residual, first cycle without a restart residual:
    the reference's control flow, so iteration counts match it.

    The reference's early-exit ``lax.while_loop`` is a Python loop here.
    Each Arnoldi step moves its Hessenberg column (at most m + 1 numbers)
    to the host, one synchronisation per step, and the small Givens and
    triangular-solve arithmetic runs there in double precision; vectors
    and the basis stay on ``b``'s device. Float32 products run in true
    float32 (no TF32).

    ``axis_name`` (the reference's row-sharded vectors over a device mesh)
    comes with the multi-GPU slice 8 of the port: anything but None
    raises."""
    if axis_name is not None:
        raise ValueError(
            f"gmres(axis_name={axis_name!r}): row-sharded GMRES over several devices is not "
            "ported yet; it comes with slice 8 (multi-GPU) of the port"
        )
    if isinstance(x0, KrylovConfig):
        raise TypeError("pass the solver config as gmres(a, b, config=...); "
                        "the third positional argument is the initial guess x0")
    a_mv = as_matvec(a)
    m_mv = as_matvec(preconditioner) if preconditioner is not None else (lambda v: v)
    n = b.shape[0]
    m = min(config.restart, n)
    dtype, dev = b.dtype, b.device
    rdtype = b.real.dtype

    def norm(v) -> float:
        return float(torch.linalg.vector_norm(v))

    def solution(x, its, res, converged):
        return KrylovSolution(
            x, torch.tensor(its, dtype=torch.int32, device=dev),
            torch.tensor(res, dtype=rdtype, device=dev), torch.tensor(converged, device=dev))

    def cycle(x, r0, tol):
        """One restart cycle from the preconditioned residual r0:
        (x_new, steps taken, Givens residual estimate)."""
        beta = norm(r0)
        basis = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        basis[0] = r0 / (beta if beta > 0 else 1.0)
        hess = np.zeros((m + 1, m), dtype=complex)  # Givens-reduced in place
        cs = np.zeros(m)
        sn = np.zeros(m, dtype=complex)
        g = np.zeros(m + 1, dtype=complex)
        g[0] = beta
        res, steps = beta, 0
        while steps < m and res > tol:
            j = steps
            steps += 1
            w = m_mv(a_mv(basis[j]))
            bj = basis[: j + 1]
            h1 = torch.conj(bj) @ w
            w = w - bj.T @ h1
            h2 = torch.conj(bj) @ w
            w = w - bj.T @ h2
            h_last = torch.linalg.vector_norm(w)
            basis[j + 1] = w / torch.where(h_last > 1e-30, h_last, 1.0)
            col = torch.cat([h1 + h2, h_last.to(dtype)[None]]).cpu().numpy().astype(complex)
            for i in range(j):  # apply the j existing rotations
                hi, hi1 = col[i], col[i + 1]
                col[i] = cs[i] * hi + sn[i] * hi1
                col[i + 1] = -np.conj(sn[i]) * hi + cs[i] * hi1
            cs[j], sn[j], col[j] = _givens_host(complex(col[j]), complex(col[j + 1]))
            col[j + 1] = 0.0
            hess[: j + 2, j] = col
            g[j + 1] = -np.conj(sn[j]) * g[j]
            g[j] = cs[j] * g[j]
            res = abs(g[j + 1])

        # Back-substitution R y = g on the steps x steps reduced system;
        # a row with a vanished pivot gets 1 added to its pivot and a zero
        # right-hand side, as the reference masks it.
        y = np.zeros(m, dtype=complex)
        for i in range(steps - 1, -1, -1):
            ok = abs(hess[i, i]) > 1e-30
            pivot = hess[i, i] if ok else hess[i, i] + 1.0
            y[i] = ((g[i] if ok else 0.0) - hess[i, i + 1:steps] @ y[i + 1:steps]) / pivot
        if steps:
            x = x + basis[:steps].T @ torch.as_tensor(y[:steps], device=dev).to(dtype)
        return x, steps, res

    with full_f32_matmul():
        mb = m_mv(b)
        b_norm = max(norm(mb), 1e-30)
        tol = config.tolerance * b_norm + config.atol
        if x0 is None:
            x, r_pre = torch.zeros_like(b), mb
        else:
            x = x0.to(dtype)
            r_pre = m_mv(b - a_mv(x))
        if config.max_iterations <= 0:
            r_init = norm(r_pre)
            return solution(x, 0, r_init / b_norm, r_init <= tol)

        x, its, res = cycle(x, r_pre, tol)
        while res > tol and its < config.max_iterations:
            x, steps, res = cycle(x, m_mv(b - a_mv(x)), tol)
            its += steps
    return solution(x, its, res / b_norm, res <= tol)
