"""Node-major batched geometric multigrid: one V-cycle preconditioning
all F frequencies at once, every level operator in DIA form
(counterpart of mathaudio_tpu/fem/multigrid_batched.py).

Vectors are (N_l, F). Smoothing and residuals are the fused DIA kernels
(fem/dia.py): each damped Jacobi step recomputes the inverse diagonal
from the three (N,) real tables and the lane scalars (the reference's
``fuse_diag=True``), and each residual is one stencil pass. Transfers are
padded gather stencils; the anchored coarse solve is one batched real
matrix product per visit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mathaudio_tpu_torch.fem.dia import DiaTables, dia_jacobi, dia_residual
from mathaudio_tpu_torch.xtypes import complex_dtype_for, full_f32_matmul


class DiaLevel(NamedTuple):
    """Tensors of one smoothing level (static offsets travel separately)."""

    tables: DiaTables  # frequency-shared (D, N_l) real tables
    p_idx: torch.Tensor  # (N_l, 2^d) int64 prolongation from level l+1
    p_w: torch.Tensor  # (N_l, 2^d)
    r_idx: torch.Tensor  # (N_{l+1}, K) int64 transposed (restriction) stencil
    r_w: torch.Tensor  # (N_{l+1}, K)


class DiaMg(NamedTuple):
    """Batched-cycle state: levels, per-level frequency scalars and the
    anchored real-embedded coarse inverses."""

    levels: Tuple[DiaLevel, ...]
    cms: Tuple[torch.Tensor, ...]  # per-level (F,) mass coefficients
    cbs: Tuple[torch.Tensor, ...]  # per-level (F,) boundary coefficients
    anchor_inv: torch.Tensor  # (n_anchor, 2Nc, 2Nc)


def make_dia_mg(
    offsets: Tuple[Tuple[int, ...], ...],
    levels: Tuple[DiaLevel, ...],
    ks,
    absorption: float,
    anchor_inv,
    shift: Tuple[float, float] = (1.0, 0.5),
    tp: Tuple[tuple, ...] = (),
    fuse_diag: bool = True,
    dims: Tuple[Tuple[int, int, int], ...] = (),
    transfer_bf16: bool = False,
) -> DiaMg:
    """Per-frequency scalars for one solve batch.

    Level 0 smooths on the TRUE operator (cm = k^2, the fine system);
    deeper levels use the shifted-Laplacian operator cm = (b1 + i b2) k^2.
    Inverse diagonals are never stored: the Jacobi kernel recomputes them
    (the reference's ``fuse_diag=True`` default). ``offsets`` are the
    levels' static diagonal offsets, checked against their tables. The
    reference's other transfer forms (``tp``, ``dims``, ``transfer_bf16``)
    and ``fuse_diag=False`` come with slice 6 of the port."""
    if tp or dims or transfer_bf16 or not fuse_diag:
        raise ValueError(
            "make_dia_mg: the tensor-product and streamed transfers (tp=, dims=, "
            "transfer_bf16=True) and fuse_diag=False are not ported yet: they come with "
            "slice 6 of the port"
        )
    if len(offsets) != len(levels) or any(
            len(offs) != lvl.tables.k.shape[0] for offs, lvl in zip(offsets, levels)):
        raise ValueError(
            f"make_dia_mg: offsets of {[len(o) for o in offsets]} diagonals do not match the "
            f"levels' tables of {[lvl.tables.k.shape[0] for lvl in levels]}"
        )
    cd = complex_dtype_for(levels[0].tables.k.dtype)
    k = ks.to(cd)
    b1, b2 = shift
    zshift = torch.tensor(b1 + 1j * b2, dtype=cd, device=k.device)
    cb = torch.tensor(-1j * absorption, dtype=cd, device=k.device) * k  # (F,), all levels
    cms, cbs = [], []
    for l in range(len(levels)):
        cms.append((k * k) if l == 0 else zshift * (k * k))
        cbs.append(cb)
    return DiaMg(tuple(levels), tuple(cms), tuple(cbs), anchor_inv)


def _prolong_b(lvl: DiaLevel, xc):
    """(N_c, F) -> (N_f, F): row-gather interpolation, one stencil column
    at a time (no (N_f, 2^d, F) intermediate)."""
    w = lvl.p_w.to(xc.dtype)
    idx = lvl.p_idx
    y = w[:, 0, None] * xc[idx[:, 0]]
    for s in range(1, idx.shape[1]):
        y = y + w[:, s, None] * xc[idx[:, s]]
    return y


def _restrict_b(lvl: DiaLevel, rf):
    """(N_f, F) -> (N_c, F): R = P^T as a coarse-side row gather with the
    transposed stencil (fem.multigrid.transpose_transfer)."""
    w = lvl.r_w.to(rf.dtype)
    idx = lvl.r_idx
    y = w[:, 0, None] * rf[idx[:, 0]]
    for s in range(1, idx.shape[1]):
        y = y + w[:, s, None] * rf[idx[:, s]]
    return y


def _coarse_solve_b(anchor_inv, r):
    """Anchored real-embedded coarse solve: r (Nc, F) with F laid out as
    n_anchor contiguous chunks -> (Nc, F). One batched product, in true
    f32 (no TF32) on the card."""
    nc, nf = r.shape
    na = anchor_inv.shape[0]
    chunk = nf // na
    r2 = torch.cat([r.real, r.imag], dim=0)  # (2Nc, F)
    r3 = r2.reshape(2 * nc, na, chunk).permute(1, 0, 2)  # (na, 2Nc, chunk)
    with full_f32_matmul():
        x3 = torch.bmm(anchor_inv.to(r2.dtype), r3)  # (na, 2Nc, chunk)
    x2 = x3.permute(1, 0, 2).reshape(2 * nc, nf)
    return torch.complex(x2[:nc], x2[nc:]).to(r.dtype)


def check_cycle(cycle: str) -> None:
    """The reference's cycle types: "v" runs; "w" and "f" come with slice 6."""
    if cycle not in ("v", "w", "f"):
        raise ValueError(f"unknown multigrid cycle type {cycle!r}")
    if cycle != "v":
        raise ValueError(
            f"multigrid cycle type {cycle!r} is not ported yet: W and F cycles come with "
            "slice 6 of the port; the V-cycle (\"v\") runs"
        )


def mg_cycle_batched(
    mgp: DiaMg,
    offsets: Tuple[Tuple[int, ...], ...],
    r,
    omega: float = 2.0 / 3.0,
    nu: int = 1,
    level: int = 0,
    cycle: str = "v",
    nu_post: Optional[int] = None,
):
    """One batched V-cycle: x ~ P^{-1} r, r (N_l, F).

    ``nu``/``nu_post``: pre/post smoothing steps, an int or a per-level
    tuple (``nu_post=None`` = ``nu``). ``cycle``: the reference's cycle
    type; "v" runs, "w" and "f" raise (``check_cycle``)."""
    check_cycle(cycle)
    if level == len(mgp.levels):
        return _coarse_solve_b(mgp.anchor_inv, r)
    if nu_post is None:
        nu_post = nu
    nu_here = nu[level] if isinstance(nu, (tuple, list)) else nu
    nu_post_here = nu_post[level] if isinstance(nu_post, (tuple, list)) else nu_post
    lvl = mgp.levels[level]
    cm, cb = mgp.cms[level], mgp.cbs[level]
    offs = offsets[level]
    if nu_here == 0:  # V(0, nu_post): the coarse grid corrects r itself
        x = torch.zeros_like(r)
        res = r
    else:
        x = dia_jacobi(offs, lvl.tables, cm, cb, None, r, omega)
        for _ in range(nu_here - 1):
            x = dia_jacobi(offs, lvl.tables, cm, cb, x, r, omega)
        res = dia_residual(offs, lvl.tables, cm, cb, x, r)
    rc = _restrict_b(lvl, res)
    xc = mg_cycle_batched(mgp, offsets, rc, omega, nu, level + 1, cycle, nu_post)
    x = x + _prolong_b(lvl, xc)
    for _ in range(nu_post_here):
        x = dia_jacobi(offs, lvl.tables, cm, cb, x, r, omega)
    return x
