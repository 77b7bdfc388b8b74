"""Krylov solvers: CG, BiCGStab, CGS, QMR-CGSTAB and restarted GMRES, with
the pipelined GMRES variants (counterpart of mathaudio_tpu/solvers/krylov.py).

The reference's ``lax.while_loop`` state machines are Python loops here:
vectors and the scalar recurrences (rho, alpha, omega, ...) stay on the
right-hand side's device as tensors, and each step reads its stop test on
the host once (one synchronisation per step). Every breakdown guard of the
reference (rho = 0, omega = 0, a vanished Givens pivot, the pipelined
variant's square-root breakdown) is kept, with its iteration-count
convention, so a float64 run counts the reference's iterations.

``axis_name`` (the reference's row-sharded vectors over a device mesh):
each rank passes its own rows of ``b`` and an operator on them, and names
the mesh axis (resolved against the mesh in use, see
parallel/mesh.py::use_mesh) or passes the process group the rows are split
over. Every inner product, norm and Gram-Schmidt projection is then
all-reduced over that group, so every stop test the host reads comes from a
reduced value that all ranks hold bit for bit: they leave each loop
together. GMRES then takes the restart length from the config as it is
(the local row count no longer bounds the Krylov dimension).
Float32 products run in true float32 (no TF32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mathaudio_tpu_torch.parallel.mesh import all_reduce_sum, axis_group
from mathaudio_tpu_torch.solvers.operators import as_matvec
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


def _givens_host(a: complex, b: complex):
    """``_givens`` on host scalars: (c, s, r)."""
    abs_a, abs_b = abs(a), abs(b)
    t = math.sqrt(abs_a**2 + abs_b**2)
    phase = a / abs_a if abs_a > 0 else 1.0 + 0.0j
    if t > 0:
        return abs_a / t, phase * b.conjugate() / t, phase * t
    return 1.0, 0.0j, phase * t


def _prep(a, m):
    return as_matvec(a), (as_matvec(m) if m is not None else (lambda v: v))


def _reducers(axis_name):
    """(vdot, norm, psum) over the process group of ``axis_name`` (None:
    this rank's vectors are the whole vectors). vdot(x, y) = sum conj(x) y
    and norm are 0-d tensors on the vectors' device."""
    group = axis_group(axis_name)

    def psum(v):
        return v if group is None else all_reduce_sum(v, group)

    return ((lambda x, y: psum(torch.sum(torch.conj(x) * y))),
            (lambda v: torch.sqrt(psum(torch.sum(torch.abs(v) ** 2)))), psum)


def _start(a, b, x0, config, preconditioner, norm):
    """Shared prologue: (A, M, x0, ||b||, tol) with ||b|| floored at 1e-30."""
    a_mv, m_mv = _prep(a, preconditioner)
    x0 = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    b_norm = max(float(norm(b)), 1e-30)
    return a_mv, m_mv, x0, b_norm, config.tolerance * b_norm + config.atol


def _solution(x, its, res, converged):
    dev = x.device
    return KrylovSolution(x, torch.tensor(its, dtype=torch.int32, device=dev),
                          torch.tensor(res, dtype=x.real.dtype, device=dev),
                          torch.tensor(converged, device=dev))


def _host(*scalars):
    """The step's stop-test scalars on the host: one synchronisation."""
    return torch.stack([torch.as_tensor(s, device=scalars[0].device).to(torch.float64)
                        for s in scalars]).tolist()


def cg(a, b, x0=None, config: KrylovConfig = KrylovConfig(), preconditioner=None,
       axis_name=None):
    """Conjugate gradients for SPD/HPD systems."""
    _vdot, _norm, _ = _reducers(axis_name)
    with full_f32_matmul():
        a_mv, m_mv, x, b_norm, tol = _start(a, b, x0, config, preconditioner, _norm)
        r = b - a_mv(x)
        z = m_mv(r)
        p = z
        rz = _vdot(r, z)
        (res,) = _host(_norm(r))
        k = 0
        while res > tol and k < config.max_iterations:
            ap = a_mv(p)
            alpha = rz / _vdot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = m_mv(r)
            rz_new = _vdot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            k += 1
            (res,) = _host(_norm(r))
    return _solution(x, k, res / b_norm, res <= tol)


def bicgstab(a, b, x0=None, config: KrylovConfig = KrylovConfig(), preconditioner=None,
             axis_name=None):
    """BiCGStab for general systems. Stops on the recurrence residual, a
    vanished rho or omega (below 1e-30), or the budget; reports the true
    residual ||b - A x||."""
    _vdot, _norm, _ = _reducers(axis_name)
    with full_f32_matmul():
        a_mv, m_mv, x, b_norm, tol = _start(a, b, x0, config, preconditioner, _norm)
        r = b - a_mv(x)
        r_hat = r
        one = torch.ones((), dtype=r.dtype, device=r.device)
        p = v = torch.zeros_like(r)
        rho = alpha = omega = one
        res, stag = _host(_norm(r), torch.zeros((), device=r.device))
        k = 0
        while res > tol and k < config.max_iterations and not stag:
            rho_new = _vdot(r_hat, r)
            beta = (rho_new / rho) * (alpha / omega)
            p = r + beta * (p - omega * v)
            p_hat = m_mv(p)
            v = a_mv(p_hat)
            alpha = rho_new / _vdot(r_hat, v)
            s = r - alpha * v
            s_hat = m_mv(s)
            t = a_mv(s_hat)
            tt = _vdot(t, t)
            omega = torch.where(torch.abs(tt) > 0, _vdot(t, s) / tt, 0 * one)
            x = x + alpha * p_hat + omega * s_hat
            r = s - omega * t
            rho = rho_new
            k += 1
            res, stag = _host(_norm(r), (torch.abs(rho_new) < 1e-30) | (torch.abs(omega) < 1e-30))
        (res,) = _host(_norm(b - a_mv(x)))
    return _solution(x, k, res / b_norm, res <= tol)


def cgs(a, b, x0=None, config: KrylovConfig = KrylovConfig(), preconditioner=None,
        axis_name=None):
    """Conjugate gradient squared; stops as ``bicgstab`` does (rho only)."""
    _vdot, _norm, _ = _reducers(axis_name)
    with full_f32_matmul():
        a_mv, m_mv, x, b_norm, tol = _start(a, b, x0, config, preconditioner, _norm)
        r = b - a_mv(x)
        r_hat = r
        p = q = torch.zeros_like(r)
        rho = torch.ones((), dtype=r.dtype, device=r.device)
        res, stag = _host(_norm(r), torch.zeros((), device=r.device))
        k = 0
        while res > tol and k < config.max_iterations and not stag:
            rho_new = _vdot(r_hat, r)
            beta = rho_new / rho
            u = r + beta * q
            p = u + beta * (q + beta * p)
            p_hat = m_mv(p)
            v = a_mv(p_hat)
            alpha = rho_new / _vdot(r_hat, v)
            q = u - alpha * v
            uq_hat = m_mv(u + q)
            x = x + alpha * uq_hat
            r = r - alpha * a_mv(uq_hat)
            rho = rho_new
            k += 1
            res, stag = _host(_norm(r), torch.abs(rho_new) < 1e-30)
        (res,) = _host(_norm(b - a_mv(x)))
    return _solution(x, k, res / b_norm, res <= tol)


def qmrcgstab(a, b, x0=None, config: KrylovConfig = KrylovConfig(), preconditioner=None,
              axis_name=None):
    """QMR-CGSTAB (Chan, Gallopoulos, Simoncini, Szeto, Tong 1994): BiCGStab
    with quasi-minimal-residual smoothing. Stops when the QMR bound
    tau sqrt(2k + 1) clears the tolerance (or on a vanished rho or omega,
    or the budget); reports the true residual."""
    _vdot, _norm, _ = _reducers(axis_name)
    with full_f32_matmul():
        a_mv, m_mv, x, b_norm, tol = _start(a, b, x0, config, preconditioner, _norm)
        r = b - a_mv(x)
        r_hat = r
        one = torch.ones((), dtype=r.dtype, device=r.device)
        p = v = d = torch.zeros_like(r)
        rho = alpha = omega = one
        tau = _norm(r)
        theta = torch.zeros((), dtype=tau.dtype, device=r.device)
        eta = 0 * one
        bound, stag = _host(tau, torch.zeros((), device=r.device))
        k = 0
        while bound > tol and k < config.max_iterations and not stag:
            rho_new = _vdot(r_hat, r)
            beta = (rho_new / rho) * (alpha / omega)
            p = r + beta * (p - omega * v)
            p_hat = m_mv(p)
            v = a_mv(p_hat)
            alpha = rho_new / _vdot(r_hat, v)
            s = r - alpha * v
            # first quasi-minimisation half-step
            theta1 = _norm(s) / tau
            c1 = 1.0 / torch.sqrt(1.0 + theta1**2)
            tau1 = tau * theta1 * c1
            eta1 = (c1**2) * alpha
            d1 = p_hat + d * ((theta**2) * eta / alpha)
            x = x + eta1 * d1
            s_hat = m_mv(s)
            t = a_mv(s_hat)
            tt = _vdot(t, t)
            omega = torch.where(torch.abs(tt) > 0, _vdot(t, s) / tt, 0 * one)
            r = s - omega * t
            # second quasi-minimisation half-step
            theta = _norm(r) / tau1
            c2 = 1.0 / torch.sqrt(1.0 + theta**2)
            tau = tau1 * theta * c2
            eta = (c2**2) * omega
            d = s_hat + d1 * ((theta1**2) * eta1 / omega)
            x = x + eta * d
            rho = rho_new
            k += 1
            bound, stag = _host(tau * math.sqrt(2.0 * k + 1.0),
                                (torch.abs(rho_new) < 1e-30) | (torch.abs(omega) < 1e-30))
        (res,) = _host(_norm(b - a_mv(x)))
    return _solution(x, k, res / b_norm, res <= tol)


def _rotate(col, cs, sn, g, j):
    """Apply the j existing Givens rotations to the Hessenberg column
    ``col`` (host, complex128), form rotation j, update the least-squares
    right-hand side ``g``; returns |g[j + 1]|, the residual estimate."""
    for i in range(j):
        hi, hi1 = col[i], col[i + 1]
        col[i] = cs[i] * hi + sn[i] * hi1
        col[i + 1] = -np.conj(sn[i]) * hi + cs[i] * hi1
    cs[j], sn[j], col[j] = _givens_host(complex(col[j]), complex(col[j + 1]))
    col[j + 1] = 0.0
    g[j + 1] = -np.conj(sn[j]) * g[j]
    g[j] = cs[j] * g[j]
    return abs(g[j + 1])


def _update(x, basis, hess, g, steps):
    """x + V y for the back-substitution R y = g on the steps x steps
    reduced system; a row with a vanished pivot gets 1 added to its pivot
    and a zero right-hand side, as the reference masks it."""
    y = np.zeros(steps, dtype=complex)
    for i in range(steps - 1, -1, -1):
        ok = abs(hess[i, i]) > 1e-30
        pivot = hess[i, i] if ok else hess[i, i] + 1.0
        y[i] = ((g[i] if ok else 0.0) - hess[i, i + 1:steps] @ y[i + 1:steps]) / pivot
    if steps:
        x = x + basis[:steps].T @ torch.as_tensor(y, device=x.device).to(x.dtype)
    return x


def _restarted(cycle, a_mv, m_mv, b, x0, config, norm):
    """The reference's outer loop around a GMRES ``cycle(x, r0, tol)`` ->
    (x, steps, residual estimate): the left-preconditioned reference norm
    ||M b||, a first cycle from M b (x0 None) or M (b - A x0), then
    restarts from the true preconditioned residual while unconverged."""
    with full_f32_matmul():
        mb = m_mv(b)
        b_norm = max(float(norm(mb)), 1e-30)
        tol = config.tolerance * b_norm + config.atol
        if x0 is None:
            x, r_pre = torch.zeros_like(b), mb
        else:
            x = x0.to(b.dtype)
            r_pre = m_mv(b - a_mv(x))
        if config.max_iterations <= 0:
            r_init = float(norm(r_pre))
            return _solution(x, 0, r_init / b_norm, r_init <= tol)

        x, its, res = cycle(x, r_pre, tol)
        while res > tol and its < config.max_iterations:
            x, steps, res = cycle(x, m_mv(b - a_mv(x)), tol)
            its += steps
    return _solution(x, its, res / b_norm, res <= tol)


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
    and the basis stay on ``b``'s device."""
    if isinstance(x0, KrylovConfig):
        raise TypeError("pass the solver config as gmres(a, b, config=...); "
                        "the third positional argument is the initial guess x0")
    _, _norm, psum = _reducers(axis_name)
    a_mv, m_mv = _prep(a, preconditioner)
    n = b.shape[0]
    m = config.restart if axis_name is not None else min(config.restart, n)
    dtype, dev = b.dtype, b.device

    def cycle(x, r0, tol):
        beta = float(_norm(r0))
        basis = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        basis[0] = r0 / (beta if beta > 0 else 1.0)
        hess = np.zeros((m + 1, m), dtype=complex)  # Givens-reduced in place
        cs, sn = np.zeros(m), np.zeros(m, dtype=complex)
        g = np.zeros(m + 1, dtype=complex)
        g[0] = beta
        res, steps = beta, 0
        while steps < m and res > tol:
            j = steps
            steps += 1
            w = m_mv(a_mv(basis[j]))
            bj = basis[: j + 1]
            h1 = psum(torch.conj(bj) @ w)
            w = w - bj.T @ h1
            h2 = psum(torch.conj(bj) @ w)
            w = w - bj.T @ h2
            h_last = _norm(w)
            basis[j + 1] = w / torch.where(h_last > 1e-30, h_last, 1.0)
            col = torch.cat([h1 + h2, h_last.to(dtype)[None]]).cpu().numpy().astype(complex)
            res = _rotate(col, cs, sn, g, j)
            hess[: j + 2, j] = col
        return _update(x, basis, hess, g, steps), steps, res

    return _restarted(cycle, a_mv, m_mv, b, x0, config, _norm)


def gmres_pipelined_ghysels(a, b, x0=None, config=KrylovConfig(), preconditioner=None,
                            axis_name=None):
    """Ghysels p(1)-GMRES (Ghysels, Ashby, Meerbergen, Vanroose 2013): one
    fused reduction per step. The projections and the candidate's norm come
    from one reduction (the norm by the Pythagorean identity ||w_perp||^2 =
    ||w||^2 - sum |h_i|^2), and the auxiliary basis Z = M A V advances by
    the same recurrence as V, so the next product M A z_j is issued before
    the reduction's results are used.

    When the Pythagorean subtraction cancels to rounding (h^2 <= 4 eps
    ||z||^2) the cycle stops with its residual estimate frozen, and the
    outer loop restarts from the true residual, as the reference does. The
    reference keeps ``gmres`` as its production solver; this is its
    measured variant."""
    _, _norm, psum = _reducers(axis_name)
    a_mv, m_mv = _prep(a, preconditioner)
    n = b.shape[0]
    m = config.restart if axis_name is not None else min(config.restart, n)
    dtype, dev = b.dtype, b.device
    eps = torch.finfo(b.real.dtype).eps

    def cycle(x, r0, tol):
        beta = float(_norm(r0))
        basis = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        basis[0] = r0 / (beta if beta > 0 else 1.0)
        zbasis = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        zbasis[0] = m_mv(a_mv(basis[0]))
        hess = np.zeros((m + 1, m), dtype=complex)
        cs, sn = np.zeros(m), np.zeros(m, dtype=complex)
        g = np.zeros(m + 1, dtype=complex)
        g[0] = beta
        res, steps, breakdown = beta, 0, False
        while steps < m and res > tol and not breakdown:
            j = steps
            steps += 1
            z = zbasis[j]  # = M A v_j, formed one step ahead
            bj = basis[: j + 1]
            # the one fused reduction: projections and the candidate's norm^2
            red = psum(torch.cat([torch.conj(bj) @ z, torch.sum(torch.abs(z) ** 2)[None].to(dtype)]))
            h, z2 = red[:-1], red[-1].real
            w = m_mv(a_mv(z))  # issued before the reduction's results are used
            h2 = z2 - torch.sum(torch.abs(h) ** 2)
            h_last = torch.sqrt(torch.clamp_min(h2, 0.0))
            safe_h = torch.where(h_last > 1e-30, h_last, 1.0)
            basis[j + 1] = (z - bj.T @ h) / safe_h
            zbasis[j + 1] = (w - zbasis[: j + 1].T @ h) / safe_h
            vals = torch.cat([h, h_last.to(dtype)[None], (h2 - 4.0 * eps * z2).to(dtype)[None]])
            vals = vals.cpu().numpy().astype(complex)
            col, breakdown = vals[:-1], vals[-1].real <= 0
            new_res = _rotate(col, cs, sn, g, j)
            hess[: j + 2, j] = col
            if not breakdown:  # on breakdown the estimate is meaningless
                res = new_res
        return _update(x, basis, hess, g, steps), steps, res

    return _restarted(cycle, a_mv, m_mv, b, x0, config, _norm)


def gmres_with_guess(a, b, x0, config=KrylovConfig(), preconditioner=None, axis_name=None):
    """``gmres`` with a required initial guess (the reference's alias)."""
    return gmres(a, b, x0=x0, config=config, preconditioner=preconditioner,
                 axis_name=axis_name)


def gmres_pipelined(a, b, x0=None, config=KrylovConfig(), preconditioner=None,
                    axis_name=None):
    """The reference's pipelined-GMRES entry point, an alias of ``gmres``:
    its measurements kept the standard solver (``gmres_pipelined_ghysels``
    is the p(1) variant); the name is kept so solver dispatch tables
    match."""
    return gmres(a, b, x0=x0, config=config, preconditioner=preconditioner,
                 axis_name=axis_name)
