"""Algebraic multigrid preconditioner (counterpart of
mathaudio_tpu/solvers/preconditioners/amg.py).

Set-up on the host (numpy and scipy.sparse): classical strength of
connection, PMIS coarsening (by the native C++ kernel; ``_pmis_python`` is
its plain twin), direct interpolation, Galerkin coarse operators
P^H A P. Apply on the device: the hierarchy becomes a
``fem.multigrid.MgParams`` (padded-ELL level operators, transfer stencils
and the coarsest level's real-embedded explicit inverse), so the damped
Jacobi V-cycle and ``solve_multigrid`` are the geometric multigrid's.
The coarsest inverse is taken of the real-embedded matrix
[[Ar, -Ai], [Ai, Ar]], in the working precision on the device, as the
reference takes it. Presets follow the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from mathaudio_tpu_torch.solvers.operators import LinearOperator
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix
from mathaudio_tpu_torch.xtypes import complex_dtype_for, default_float, resolve_device


@dataclasses.dataclass
class AmgConfig:
    strength_threshold: float = 0.25
    max_levels: int = 10
    coarse_size: int = 64
    omega: float = 2.0 / 3.0
    nu: int = 2
    max_interp_points: int = 4

    @classmethod
    def for_fem(cls) -> "AmgConfig":
        return cls(strength_threshold=0.25)

    @classmethod
    def for_bem(cls) -> "AmgConfig":
        return cls(strength_threshold=0.5, max_interp_points=6)

    @classmethod
    def for_parallel(cls) -> "AmgConfig":
        return cls(strength_threshold=0.25, nu=1)

    @classmethod
    def for_difficult_problems(cls) -> "AmgConfig":
        return cls(strength_threshold=0.5, nu=3, max_interp_points=8)


def _strength_graph(a: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Classical strength: |a_ij| >= theta * max_{l != i} |a_il|."""
    a = a.tocsr()
    abs_a = abs(a)
    abs_a.setdiag(0)
    row_max = abs_a.max(axis=1).toarray().ravel()
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    strong = (np.abs(a.data) >= theta * np.maximum(row_max[rows], 1e-300)) & (
        rows != a.indices
    )
    # copied index arrays: eliminate_zeros() works in place
    s = sp.csr_matrix(
        (strong.astype(np.int8), a.indices.copy(), a.indptr.copy()), shape=a.shape
    )
    s.eliminate_zeros()
    return s


def _pmis_graph(s: sp.csr_matrix, seed: int):
    """The symmetrized strength graph and PMIS's node weights: the degree
    plus a uniform tie-break from numpy's seeded generator."""
    n = s.shape[0]
    sym = ((s + s.T) > 0).astype(np.int8)
    rng = np.random.default_rng(seed)
    weight = np.asarray(sym.sum(axis=1)).ravel().astype(float) + rng.random(n)
    return sym.indptr, sym.indices, weight


def _pmis(s: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """PMIS coarsening by the native C++ kernel: bool is_coarse (N,)."""
    from mathaudio_tpu_torch import native

    return native.pmis_coarsen(*_pmis_graph(s, seed))


def _pmis_python(s: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """The reference's Python loop: the plain twin of ``_pmis``."""
    indptr, indices, weight = _pmis_graph(s, seed)
    state = np.zeros(s.shape[0], np.int8)  # 0 undecided, 1 coarse, -1 fine
    while (state == 0).any():
        new_coarse = []
        for i in np.where(state == 0)[0]:
            nbrs = indices[indptr[i]: indptr[i + 1]]
            if not any(state[j] == 0 and weight[j] > weight[i] for j in nbrs):
                new_coarse.append(i)
        if not new_coarse:
            # tie-break stall: promote the heaviest undecided node
            new_coarse = [int(np.where(state == 0)[0][np.argmax(weight[state == 0])])]
        for i in new_coarse:
            state[i] = 1
            for j in indices[indptr[i]: indptr[i + 1]]:
                if state[j] == 0:
                    state[j] = -1
    return state == 1


def _direct_interpolation(a: sp.csr_matrix, s: sp.csr_matrix, is_coarse, max_pts: int):
    """Classical direct interpolation: a fine row interpolates from its
    strong coarse neighbours (at most ``max_pts``, the largest kept)."""
    n = a.shape[0]
    coarse_id = np.cumsum(is_coarse) - 1
    nc = int(is_coarse.sum())
    rows, cols, vals = [], [], []
    ai, aj, av = a.indptr, a.indices, a.data
    si, sj = s.indptr, s.indices
    for i in range(n):
        if is_coarse[i]:
            rows.append(i)
            cols.append(coarse_id[i])
            vals.append(1.0)
            continue
        strong_c = [j for j in sj[si[i]: si[i + 1]] if is_coarse[j]]
        if not strong_c:
            continue  # isolated fine point: interpolates zero (the smoother fixes it)
        diag = 0.0
        sum_all = 0.0
        sum_c = 0.0
        a_ij = {}
        for j, v in zip(aj[ai[i]: ai[i + 1]], av[ai[i]: ai[i + 1]]):
            if j == i:
                diag += v
            else:
                sum_all += v
                if j in strong_c:
                    a_ij[j] = a_ij.get(j, 0.0) + v
                    sum_c += v
        if abs(sum_c) < 1e-300 or abs(diag) < 1e-300:
            continue
        if len(a_ij) > max_pts:
            keep = sorted(a_ij, key=lambda j: -abs(a_ij[j]))[:max_pts]
            dropped = sum(v for j, v in a_ij.items() if j not in keep)
            a_ij = {j: a_ij[j] for j in keep}
            sum_c -= dropped
            if abs(sum_c) < 1e-300:
                continue
        alpha = sum_all / sum_c
        for j, v in a_ij.items():
            rows.append(i)
            cols.append(coarse_id[j])
            vals.append(-alpha * v / diag)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, nc))


def _padded(a: sp.csr_matrix):
    """(indices (n, W) int32, values (n, W)) of the padded-ELL layout, rows
    in CSR order, W = max(row length, 1), padding index 0 value 0."""
    a = a.tocsr()
    ell = CsrMatrix(a.indptr, a.indices, a.data, a.shape).to_ell(max_nnz=1)
    return ell.indices, ell.values


class AmgPreconditioner(LinearOperator):
    """M^{-1} r = one AMG V-cycle; ``solve`` runs it as a stand-alone
    solver. Levels on ``device`` (default ``cuda``) in the complex dtype
    of the real ``dtype`` (default float32)."""

    def __init__(self, a, config: Optional[AmgConfig] = None, *, dtype=None, device=None):
        from mathaudio_tpu_torch.fem.multigrid import MgLevel, MgParams, transpose_transfer

        cfg = config or AmgConfig()
        self.config = cfg
        device = resolve_device(device)
        rdtype = dtype or default_float()
        cdtype = complex_dtype_for(rdtype)
        if isinstance(a, CsrMatrix):
            a_sp = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
        elif sp.issparse(a):
            a_sp = a.tocsr()
        else:
            a_sp = sp.csr_matrix(np.asarray(a))
        a_sp = a_sp.astype(np.complex128)

        sizes = [a_sp.shape[0]]
        ops = []
        cur = a_sp
        for _ in range(cfg.max_levels - 1):
            if cur.shape[0] <= cfg.coarse_size:
                break
            s = _strength_graph(cur, cfg.strength_threshold)
            is_coarse = _pmis(s)
            nc = int(is_coarse.sum())
            if nc == 0 or nc >= cur.shape[0]:
                break
            p = _direct_interpolation(cur, s, is_coarse, cfg.max_interp_points)
            coarse = (p.conj().T @ cur @ p).tocsr()
            ops.append((cur, p))
            sizes.append(coarse.shape[0])
            cur = coarse

        def tensor(x, dt=None):
            return torch.as_tensor(x, dtype=dt, device=device)

        levels: List[MgLevel] = []
        for a_l, p in ops:
            ell_idx, ell_val = _padded(a_l)
            diag = np.asarray(a_l.diagonal())
            inv_diag = np.where(np.abs(diag) > 1e-300, 1.0 / np.where(diag == 0, 1, diag), 1.0)
            p_idx, p_w = _padded(p)
            r_idx, r_w = transpose_transfer(p_idx, p_w.real, p.shape[1])
            levels.append(MgLevel(
                tensor(ell_idx, torch.int64), tensor(ell_val, cdtype), tensor(inv_diag, cdtype),
                tensor(p_idx, torch.int64), tensor(p_w.real, rdtype),
                tensor(r_idx, torch.int64), tensor(r_w, rdtype),
            ))

        dense = np.asarray(cur.todense())
        ar, ai = dense.real, dense.imag
        embedded = tensor(np.block([[ar, -ai], [ai, ar]]), rdtype)
        self.mgp = MgParams(tuple(levels), torch.linalg.inv(embedded))
        self.grid_complexity = sum(sizes) / sizes[0]
        self.operator_complexity = (
            sum(op.nnz for op, _ in ops) + cur.nnz
        ) / max(a_sp.nnz, 1)
        self.level_sizes = sizes

    @classmethod
    def _from_hierarchy(cls, mgp, config: AmgConfig) -> "AmgPreconditioner":
        """The preconditioner around an already built hierarchy (what
        ``convert.amg_preconditioner_from_numpy`` carries across)."""
        pre = cls.__new__(cls)
        pre.config, pre.mgp = config, mgp
        pre.level_sizes = ([lvl.ell_indices.shape[0] for lvl in mgp.levels]
                           + [mgp.coarse_inv.shape[-1] // 2])
        pre.grid_complexity = sum(pre.level_sizes) / pre.level_sizes[0]
        return pre

    def matvec(self, r):
        from mathaudio_tpu_torch.fem.multigrid import vcycle

        cdtype = complex_dtype_for(self.mgp.coarse_inv.dtype)
        out = vcycle(self.mgp, r.to(cdtype), omega=self.config.omega, nu=self.config.nu)
        if not r.is_complex():
            return out.real.to(r.dtype)
        return out

    def solve(self, b, tol: float = 1e-8, max_cycles: int = 100):
        from mathaudio_tpu_torch.fem.multigrid import solve_multigrid

        return solve_multigrid(self.mgp, b.to(complex_dtype_for(self.mgp.coarse_inv.dtype)),
                               tol=tol, max_cycles=max_cycles)
