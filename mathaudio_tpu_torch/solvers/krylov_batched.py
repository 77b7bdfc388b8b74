"""Node-major batched GMRES: F systems solved at once, vectors (N, F)
(counterpart of mathaudio_tpu/solvers/krylov_batched.py).

Restarted GMRES(m) with classical Gram-Schmidt Arnoldi (one or two
passes), per-lane Givens least squares and lockstep per-lane convergence.
Everything per-frequency is an (F,) lane vector. The control flow follows
the reference exactly (first restart cycle outside the loop, done-masking
inside the cycle, convergence decided on the Givens residual), so the
iteration counts match it lane for lane. The reference's
``lax.while_loop`` becomes a Python loop whose condition is read on the
host once per restart cycle.

``vmapped=True`` follows instead ``vmap`` of the single-vector ``gmres``
(the reference's per-frequency solves batched by ``jax.vmap``): a restart
cycle stops once every lane is done (one host read per Arnoldi step), and
a lane that has converged or spent its budget keeps its x, iterations and
residual while the others restart. The arithmetic of each lane is the same
in both modes.

A caller whose operator can apply one lane without touching the others
(a dense band: one GEMV a lane) passes ``a_mv_lanes``. Each Arnoldi step
then reads ``done`` on the host once and applies the operator only to the
lanes still iterating; a done lane's column is zero and everything it
would feed is kept by the done-mask, so x, iterations and residual are
those of the path without it. The cycle stops once no lane iterates (the
``vmapped`` rule, which the done-mask makes equal to running the steps).
The restart residual stays a full application: it decides whether a lane
that had converged iterates again. ``gmres.matvecs`` counts applications
of the whole operator: a step on k of F lanes counts k / F, and
``gmres.lane_steps_skipped`` the F - k lanes left out.
"""

from __future__ import annotations

import torch

from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, KrylovSolution, _givens
from mathaudio_tpu_torch.utils.profiling import count, region


def _bnorm(v):
    """(N, F) -> (F,) 2-norm over nodes."""
    return torch.sqrt(torch.sum(torch.abs(v) ** 2, dim=0))


def _dotc(bj, w):
    """Lane-batched projections <b_i, w>: (j+1, N, F), (N, F) -> (j+1, F)."""
    return torch.sum(torch.conj(bj) * w[None], dim=1)


def _expand(h, bj):
    """sum_i h[i] b_i: (j+1, F), (j+1, N, F) -> (N, F)."""
    return torch.sum(h[:, None, :] * bj, dim=0)


def _any_on_host(mask) -> bool:
    """Read ``torch.any(mask)`` on the host (counted as ``host_sync.gmres``)."""
    count("host_sync.gmres")
    return bool(torch.any(mask))


def gmres_batched(a_mv, b, config: KrylovConfig = KrylovConfig(), preconditioner=None,
                  orth: str = "cgs2", x0=None, a_res=None, vmapped: bool = False,
                  a_mv_lanes=None):
    """Solve F systems A_f x_f = b_f, vectors stored (N, F).

    ``a_mv`` / ``preconditioner``: (N, F) -> (N, F), applying each lane's
    operator to its column. ``a_res``: optional fused (b, x) -> b - A x
    (the DIA residual kernel); defaults to ``b - a_mv(x)``. Returns
    KrylovSolution with x (N, F), iterations (F,) int32, residual (F,),
    converged (F,) bool.

    ``x0``: optional (N, F) warm start (one extra residual to form the
    initial residual; convergence stays gated on ``tol * ||M b||``).

    ``orth``: "cgs2" (two classical Gram-Schmidt passes) or "cgs1" (one
    pass; safe only for strongly preconditioned short cycles such as the
    MG-preconditioned room sweep at restart 6).

    ``vmapped``: the lane semantics of the vmapped single-vector solver
    (module notes).

    ``a_mv_lanes``: optional (v, lanes) -> (N, F) applying the operator of
    each lane in the host list ``lanes`` to its column of v and leaving the
    other columns zero; the Arnoldi steps then skip the done lanes (module
    notes)."""
    if orth not in ("cgs1", "cgs2"):
        raise ValueError(f"unknown orthogonalization {orth!r}")
    with region("gmres"):
        m_mv = preconditioner if preconditioner is not None else (lambda v: v)
        if a_res is None:
            a_res = lambda rhs, x: rhs - a_mv(x)  # noqa: E731
        n, nf = b.shape
        m = min(config.restart, n)
        dtype = b.dtype
        rdtype = b.real.dtype
        dev = b.device

        mb = m_mv(b)
        b_norm = torch.clamp_min(_bnorm(mb), 1e-30)
        count("host_sync.upload")
        tol = torch.tensor(config.tolerance, dtype=rdtype, device=dev) * b_norm + config.atol

        if x0 is None:
            x0 = torch.zeros_like(b)
            r_pre0 = mb
        else:
            x0 = x0.to(dtype)
            count("gmres.matvecs")
            r_pre0 = m_mv(a_res(b, x0))

        def cycle(x, r0, total_it):
            count("gmres.cycles")
            beta = _bnorm(r0)  # (F,)
            safe_beta = torch.where(beta > 0, beta, 1.0)
            v0 = r0 / safe_beta.to(dtype)[None, :]

            basis = torch.zeros((m + 1, n, nf), dtype=dtype, device=dev)
            basis[0] = v0
            hess = torch.zeros((m + 1, m, nf), dtype=dtype, device=dev)
            cs = torch.zeros((m, nf), dtype=rdtype, device=dev)
            sn = torch.zeros((m, nf), dtype=dtype, device=dev)
            g = torch.zeros((m + 1, nf), dtype=dtype, device=dev)
            g[0] = beta.to(dtype)
            res = beta
            done = beta <= tol
            cnt = torch.zeros((nf,), dtype=torch.int32, device=dev)

            # Arnoldi unrolled over j: each projection reads only the j + 1
            # basis vectors that exist.
            steps = m
            for j in range(m):
                # a break: the remaining steps would be no-ops on every lane
                if a_mv_lanes is None:
                    if vmapped and not _any_on_host(~done):
                        steps = j
                        break
                    count("gmres.matvecs")
                    av = a_mv(basis[j])
                else:
                    count("host_sync.gmres")
                    lanes = [f for f, live in enumerate((~done).tolist()) if live]
                    if not lanes:
                        steps = j
                        break
                    count("gmres.matvecs", len(lanes) / nf)
                    count("gmres.lane_steps_skipped", nf - len(lanes))
                    av = a_mv_lanes(basis[j], lanes)
                cnt = cnt + torch.where(done, 0, 1).to(torch.int32)
                w = m_mv(av)
                bj = basis[: j + 1]
                h1 = _dotc(bj, w)
                w = w - _expand(h1, bj)
                if orth == "cgs2":
                    h2 = _dotc(bj, w)
                    w = w - _expand(h2, bj)
                    h1 = h1 + h2
                h = torch.cat([h1, torch.zeros((m - j, nf), dtype=dtype, device=dev)])
                h_last = _bnorm(w)
                safe_h = torch.where(h_last > 1e-30, h_last, 1.0)
                v_next = w / safe_h.to(dtype)[None, :]
                basis[j + 1] = torch.where(done[None, :], basis[j + 1], v_next)
                h[j + 1] = h_last.to(dtype)

                for i in range(j):  # apply the j existing rotations
                    hi, hi1 = h[i], h[i + 1]
                    new_i = cs[i] * hi + sn[i] * hi1
                    new_i1 = -torch.conj(sn[i]) * hi + cs[i] * hi1
                    h[i], h[i + 1] = new_i, new_i1
                c_j, s_j, r_j = _givens(h[j], h[j + 1])
                h[j] = r_j
                h[j + 1] = 0
                g_j = g[j].clone()
                g[j] = torch.where(done, g[j], c_j * g_j)
                g[j + 1] = torch.where(done, g[j + 1], -torch.conj(s_j) * g_j)
                cs[j] = torch.where(done, cs[j], c_j)
                sn[j] = torch.where(done, sn[j], s_j)
                hess[:, j] = torch.where(done[None, :], hess[:, j], h)
                new_res = torch.abs(g[j + 1])
                res = torch.where(done, res, new_res)
                done = done | (new_res <= tol)

            # Per-lane back-substitution R y = g (upper triangular) over the
            # steps taken; the rows of steps not taken are zero (y = 0 there).
            ar = torch.arange(steps, device=dev)
            diag = torch.abs(hess[ar, ar])  # (steps, F)
            ok = diag > 1e-30
            rhs = torch.where(ok, g[:steps], 0)
            y = torch.zeros((steps, nf), dtype=dtype, device=dev)
            one = torch.ones((), dtype=dtype, device=dev)
            for i in range(steps - 1, -1, -1):
                acc = rhs[i] - torch.sum(hess[i, :steps, :] * y, dim=0)
                di = torch.where(ok[i], hess[i, i], one)
                y[i] = torch.where(ok[i], acc / di, 0)
            x_new = x + _expand(y, basis[:steps]) if steps else x
            return x_new, total_it + cnt, res

        r_init = _bnorm(r_pre0)
        if config.max_iterations <= 0:
            return KrylovSolution(x0, torch.zeros((nf,), dtype=torch.int32, device=dev),
                                  r_init / b_norm, r_init <= tol)

        x, it, res = cycle(x0, r_pre0, torch.zeros((nf,), dtype=torch.int32, device=dev))
        converged = res <= tol
        active = (~converged) & (it < config.max_iterations)
        # Converged lanes ride along: their restart residual is below tol, so the
        # cycle's done-mask leaves them untouched (``vmapped`` freezes them).
        while _any_on_host(active):
            count("gmres.matvecs")
            r_pre = m_mv(a_res(b, x))
            x_new, it_new, res_new = cycle(x, r_pre, it)
            if vmapped:
                x = torch.where(active[None, :], x_new, x)
                it = torch.where(active, it_new, it)
                res = torch.where(active, res_new, res)
            else:
                x, it, res = x_new, it_new, res_new
            converged = res <= tol
            active = (~converged) & (it < config.max_iterations)
        return KrylovSolution(x, it, res / b_norm, converged)
