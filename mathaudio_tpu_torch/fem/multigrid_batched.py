"""Node-major batched geometric multigrid: one V/W/F cycle preconditioning
all F frequencies at once, every level operator in DIA form
(counterpart of mathaudio_tpu/fem/multigrid_batched.py).

Vectors are (N_l, F). Smoothing and residuals are the fused DIA kernels
(fem/dia.py): each damped Jacobi step recomputes the inverse diagonal
from the three (N,) real tables and the lane scalars (``fuse_diag=True``,
the default), or reads the (N_l, F) inverse diagonals ``make_dia_mg``
stored (``fuse_diag=False``: the kernel forms the residual, the update is
one elementwise pass). The W and F cycles' second coarse visit starts
from one more residual kernel on the coarser level.

Transfers, all the same operator: padded gather stencils (the default),
the separable 1D factors as three per-axis real matrix products in true
float32 (``tp``), the per-axis interleaves and decimations as slices and
adds (``dims``), and those with the traffic in bfloat16 re/im planes
(``transfer_bf16``; ~4e-3 relative rounding inside the preconditioner).
The anchored coarse solve is one batched real matrix product per visit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mathaudio_tpu_torch.fem.dia import DiaTables, _inv_diag, dia_jacobi, dia_residual
from mathaudio_tpu_torch.fem.multigrid import _embedded_solve, _gather_sum
from mathaudio_tpu_torch.xtypes import complex_dtype_for, full_f32_matmul


class DiaLevel(NamedTuple):
    """Tensors of one smoothing level (static offsets travel separately)."""

    tables: DiaTables  # frequency-shared (D, N_l) real tables
    p_idx: torch.Tensor  # (N_l, 2^d) int64 prolongation from level l+1
    p_w: torch.Tensor  # (N_l, 2^d)
    r_idx: torch.Tensor  # (N_{l+1}, K) int64 transposed (restriction) stencil
    r_w: torch.Tensor  # (N_{l+1}, K)


class DiaMg(NamedTuple):
    """Batched-cycle state: levels, per-level frequency scalars, the
    stored inverse diagonals (empty when fused), the anchored coarse
    inverses and the transfer form."""

    levels: Tuple[DiaLevel, ...]
    cms: Tuple[torch.Tensor, ...]  # per-level (F,) mass coefficients
    cbs: Tuple[torch.Tensor, ...]  # per-level (F,) boundary coefficients
    # Per-level (N_l, F) inverse diagonals, or () for the Jacobi kernel to
    # recompute them from the (N,) tables (make_dia_mg fuse_diag).
    inv_diags: Tuple[torch.Tensor, ...]
    anchor_inv: torch.Tensor  # (n_anchor, 2Nc, 2Nc) real-embedded inverses
    # Per-level (pz, py, px) 1D prolongation factors, each
    # (n_f_ax + 1, n_c_ax + 1), or () for the gather stencil.
    tp: Tuple[tuple, ...] = ()
    # Per-mesh (nx, ny, nz) node counts (len(levels) + 1 entries) for the
    # streamed per-axis transfers, or () for the gather/tp dispatch.
    dims: Tuple[Tuple[int, int, int], ...] = ()
    # With dims: the streamed transfers on bfloat16 re/im planes.
    transfer_bf16: bool = False


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
    """Per-frequency scalars (and, unless fused, inverse diagonals) for
    one solve batch.

    Level 0 smooths on the TRUE operator (cm = k^2, the fine system);
    deeper levels use the shifted-Laplacian operator cm = (b1 + i b2) k^2.
    ``fuse_diag`` (default): the Jacobi kernel recomputes each inverse
    diagonal from three (N,) tables; False stores them, (N_l, F) each.
    ``offsets`` are the levels' static diagonal offsets, checked against
    their tables. ``tp``, ``dims`` and ``transfer_bf16`` pick the
    transfer form (see the module notes)."""
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
    cms, cbs, inv_diags = [], [], []
    for l, lvl in enumerate(levels):
        cm = (k * k) if l == 0 else zshift * (k * k)
        if not fuse_diag:
            inv_diags.append(_inv_diag(lvl.tables, cm, cb))
        cms.append(cm)
        cbs.append(cb)
    return DiaMg(tuple(levels), tuple(cms), tuple(cbs), tuple(inv_diags), anchor_inv,
                 tuple(tp), tuple(dims), transfer_bf16)


def _real_view(x):
    """(N, F) complex -> ((N, 2F) real re/im-interleaved view, undo).

    The transfers are real linear maps over nodes, so they apply to the
    interleaved real view unchanged and every product stays real."""
    rdt = torch.float32 if x.dtype == torch.complex64 else torch.float64
    return x.contiguous().view(rdt), lambda y: y.contiguous().view(x.dtype)


def _prolong_tp(tp, xc):
    """Separable prolongation on a lexicographic box grid (x fastest):
    P = Pz (x) Py (x) Px as three per-axis real matrix products (true
    float32 on the card: no TF32)."""
    pz, py, px = tp
    cz, cy, cx = pz.shape[1], py.shape[1], px.shape[1]
    xr, undo = _real_view(xc)
    x4 = xr.reshape(cz, cy, cx, xr.shape[1])
    rdt = x4.dtype
    with full_f32_matmul():
        x4 = torch.einsum("zyxl,Xx->zyXl", x4, px.to(rdt))
        x4 = torch.einsum("zyxl,Yy->zYxl", x4, py.to(rdt))
        x4 = torch.einsum("zyxl,Zz->Zyxl", x4, pz.to(rdt))
    return undo(x4.reshape(pz.shape[0] * py.shape[0] * px.shape[0], -1))


def _restrict_tp(tp, rf):
    """Separable restriction R = P^T: the same three per-axis products with
    the 1D factors transposed, the largest axis contracted first."""
    pz, py, px = tp
    fz, fy, fx = pz.shape[0], py.shape[0], px.shape[0]
    xr, undo = _real_view(rf)
    x4 = xr.reshape(fz, fy, fx, xr.shape[1])
    rdt = x4.dtype
    with full_f32_matmul():
        x4 = torch.einsum("zyxl,zZ->Zyxl", x4, pz.to(rdt))
        x4 = torch.einsum("zyxl,yY->zYxl", x4, py.to(rdt))
        x4 = torch.einsum("zyxl,xX->zyXl", x4, px.to(rdt))
    return undo(x4.reshape(pz.shape[1] * py.shape[1] * px.shape[1], -1))


def _interp_axis(x, n: int):
    """1D linear interpolation along axis 1 of (pre, n, post): even output
    rows copy the input, odd rows average neighbours (prolongation_1d)."""
    pre, _, post = x.shape
    mid = 0.5 * (x[:, :-1, :] + x[:, 1:, :])
    core = torch.stack([x[:, :-1, :], mid], dim=2).reshape(pre, 2 * (n - 1), post)
    return torch.cat([core, x[:, -1:, :]], dim=1)


def _decimate_axis(x, n_c: int):
    """Transpose of :func:`_interp_axis` along axis 1 of (pre, n_f, post):
    r[c] = f[2c] + 0.5 (f[2c-1] + f[2c+1]), two strided row slices."""
    even = x[:, ::2, :]
    zero = torch.zeros((x.shape[0], 1, x.shape[2]), dtype=x.dtype, device=x.device)
    oddp = torch.cat([zero, x[:, 1::2, :], zero], dim=1)
    return even + 0.5 * (oddp[:, :-1, :] + oddp[:, 1:, :])


def _prolong_stream(dims_c, xc):
    """Separable streamed prolongation on a lexicographic box grid:
    (N_c, F) -> (N_f, F) as three per-axis interleaves. ``dims_c`` =
    (nx_c, ny_c, nz_c) node counts."""
    nxc, nyc, nzc = dims_c
    f = xc.shape[1]
    x = _interp_axis(xc.reshape(nzc * nyc, nxc, f), nxc)
    nxf = 2 * nxc - 1
    x = _interp_axis(x.reshape(nzc, nyc, nxf * f), nyc)
    nyf = 2 * nyc - 1
    x = _interp_axis(x.reshape(1, nzc, nyf * nxf * f), nzc)
    return x.reshape((2 * nzc - 1) * nyf * nxf, f)


def _restrict_stream(dims_f, rf):
    """Separable streamed restriction R = P^T: (N_f, F) -> (N_c, F) as
    three per-axis decimations, the outermost axis first."""
    nxf, nyf, nzf = dims_f
    f = rf.shape[1]
    x = _decimate_axis(rf.reshape(1, nzf, nyf * nxf * f), (nzf + 1) // 2)
    nzc = (nzf + 1) // 2
    x = _decimate_axis(x.reshape(nzc, nyf, nxf * f), (nyf + 1) // 2)
    nyc = (nyf + 1) // 2
    x = _decimate_axis(x.reshape(nzc * nyc, nxf, f), (nxf + 1) // 2)
    return x.reshape(nzc * nyc * ((nxf + 1) // 2), f)


def _prolong_stream16(dims_c, xc):
    """Streamed prolongation on bfloat16 planes: the real and imaginary
    parts prolonged apart in bfloat16 (each elementwise op rounded), then
    recombined in the caller's dtype."""
    pr = _prolong_stream(dims_c, xc.real.to(torch.bfloat16))
    pi = _prolong_stream(dims_c, xc.imag.to(torch.bfloat16))
    return torch.complex(pr.to(torch.float32), pi.to(torch.float32)).to(xc.dtype)


def _restrict_stream16(dims_f, rf):
    """Streamed restriction on bfloat16 planes (see _prolong_stream16)."""
    rr = _restrict_stream(dims_f, rf.real.to(torch.bfloat16))
    ri = _restrict_stream(dims_f, rf.imag.to(torch.bfloat16))
    return torch.complex(rr.to(torch.float32), ri.to(torch.float32)).to(rf.dtype)


def _prolong_b(lvl: DiaLevel, xc, tp=(), dims_c=(), bf16: bool = False):
    """(N_c, F) -> (N_f, F): streamed per-axis interleaves when the coarse
    grid dims are given, separable products with the level's 1D factors,
    else the row-gather stencil."""
    if dims_c:
        return _prolong_stream16(dims_c, xc) if bf16 else _prolong_stream(dims_c, xc)
    if tp:
        return _prolong_tp(tp, xc)
    return _gather_sum(lvl.p_idx, lvl.p_w.to(xc.dtype), xc)


def _restrict_b(lvl: DiaLevel, rf, n_coarse: int, tp=(), dims_f=(), bf16: bool = False):
    """(N_f, F) -> (N_c, F): R = P^T by streamed decimations when the fine
    grid dims are given, separable products, else a coarse-side row
    gather with the transposed stencil (fem.multigrid.transpose_transfer)."""
    del n_coarse  # shape comes from the transposed stencil
    if dims_f:
        return _restrict_stream16(dims_f, rf) if bf16 else _restrict_stream(dims_f, rf)
    if tp:
        return _restrict_tp(tp, rf)
    return _gather_sum(lvl.r_idx, lvl.r_w.to(rf.dtype), rf)


def _coarse_solve_b(anchor_inv, r):
    """Anchored real-embedded coarse solve: r (Nc, F) with F laid out as
    n_anchor contiguous chunks -> (Nc, F). One batched product, in true
    f32 (no TF32) on the card."""
    return _embedded_solve(anchor_inv, r)


def check_cycle(cycle: str) -> None:
    """The reference's cycle types: "v", "w" and "f"."""
    if cycle not in ("v", "w", "f"):
        raise ValueError(f"unknown multigrid cycle type {cycle!r}")


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
    """One batched multigrid cycle: x ~ P^{-1} r, r (N_l, F).

    ``cycle`` "v" (one coarse visit), "w" (two) or "f" (an F visit, then
    a V visit). ``nu``/``nu_post``: pre/post smoothing steps, an int or a
    per-level tuple (``nu_post=None`` = ``nu``)."""
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
    if mgp.inv_diags:  # stored inverse diagonals: residual kernel + one update
        om = torch.tensor(omega, dtype=r.dtype, device=r.device)
        inv_diag = mgp.inv_diags[level]

        def smooth(x):
            if x is None:
                return om * inv_diag * r
            return x + om * inv_diag * dia_residual(offs, lvl.tables, cm, cb, x, r)
    else:  # fused: the Jacobi kernel recomputes D^-1 from the (N,) tables
        def smooth(x):
            return dia_jacobi(offs, lvl.tables, cm, cb, x, r, omega)

    if nu_here == 0:  # V(0, nu_post): the coarse grid corrects r itself
        x = torch.zeros_like(r)
        res = r
    else:
        x = smooth(None)
        for _ in range(nu_here - 1):
            x = smooth(x)
        res = dia_residual(offs, lvl.tables, cm, cb, x, r)
    n_coarse = (
        mgp.levels[level + 1].tables.dk.shape[0]
        if level + 1 < len(mgp.levels)
        else mgp.anchor_inv.shape[1] // 2
    )
    tp_l = mgp.tp[level] if level < len(mgp.tp) else ()
    dims_f = mgp.dims[level] if level < len(mgp.dims) else ()
    dims_c = mgp.dims[level + 1] if level + 1 < len(mgp.dims) else ()
    rc = _restrict_b(lvl, res, n_coarse, tp_l, dims_f, mgp.transfer_bf16)
    xc = mg_cycle_batched(mgp, offsets, rc, omega, nu, level + 1, cycle, nu_post)
    if cycle in ("w", "f") and level + 1 < len(mgp.levels):
        # second coarse visit on the updated residual (W: same cycle type;
        # F: a V-cycle); skipped when the next level is the exact solve
        nxt = mgp.levels[level + 1]
        rc2 = dia_residual(offsets[level + 1], nxt.tables, mgp.cms[level + 1],
                           mgp.cbs[level + 1], xc, rc)
        second = "v" if cycle == "f" else "w"
        xc = xc + mg_cycle_batched(mgp, offsets, rc2, omega, nu, level + 1, second, nu_post)
    x = x + _prolong_b(lvl, xc, tp_l, dims_c, mgp.transfer_bf16)
    for _ in range(nu_post_here):
        x = smooth(x)
    return x
