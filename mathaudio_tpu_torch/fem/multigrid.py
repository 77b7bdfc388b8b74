"""Geometric multigrid with the shifted-Laplacian preconditioner
(counterpart of mathaudio_tpu/fem/multigrid.py).

Nested structured hierarchies by factor-2 coarsening; transfers are exact
multilinear interpolation stencils (padded gather tables, separable into
the 1D factors of ``prolongation_1d``); smoothing is damped Jacobi over
ELL level operators; the coarsest complex shifted operator
P = K - (b1 + i b2) k^2 M + c B is applied through a real-embedded
explicit inverse (one per frequency, or one per anchor of a band, chained
by Newton-Schulz refinement).

The single-vector cycle (``mg_cycle``) also runs a node-major band: with
a (F,) tensor of wavenumbers ``build_mg_levels`` gives per-lane tables
(ELL values (N, W, F), inverse diagonals (N, F)) and ``build_coarse_inv``
one inverse per lane, and the cycle applies them to (N, F) vectors with
each lane taking exactly its single-vector arithmetic. That is how the
frequency-major sweep (models/helmholtz_room.py::sweep_pressure) runs the
reference's per-frequency vmap as one batched solve.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mathaudio_tpu_torch.fem.assembly import HelmholtzAssembler, scatter_diag, scatter_ell
from mathaudio_tpu_torch.fem.mesh import Mesh, box_mesh_tetrahedra, rectangular_mesh_triangles
from mathaudio_tpu_torch.xtypes import (
    complex_dtype_for,
    default_float,
    full_f32_matmul,
    resolve_device,
)


def box_hierarchy(n: int, levels: int, bounds=(0.0, 1.0, 0.0, 1.0, 0.0, 1.0)) -> List[Mesh]:
    """Fine-to-coarse nested box meshes; n must be divisible by 2^(levels-1)."""
    if n % (2 ** (levels - 1)):
        raise ValueError(f"n={n} is not divisible by 2^(levels-1) for {levels} levels")
    x0, x1, y0, y1, z0, z1 = bounds
    return [
        box_mesh_tetrahedra(x0, x1, y0, y1, z0, z1, n >> l, n >> l, n >> l)
        for l in range(levels)
    ]


def rect_hierarchy(n: int, levels: int, bounds=(0.0, 1.0, 0.0, 1.0)) -> List[Mesh]:
    """Fine-to-coarse nested triangle meshes of a rectangle."""
    if n % (2 ** (levels - 1)):
        raise ValueError(f"n={n} is not divisible by 2^(levels-1) for {levels} levels")
    x0, x1, y0, y1 = bounds
    return [rectangular_mesh_triangles(x0, x1, y0, y1, n >> l, n >> l) for l in range(levels)]


def box_hierarchy_dims(dims, levels: int, bounds=(0.0, 1.0, 0.0, 1.0, 0.0, 1.0)):
    """Anisotropic nested box hierarchy: dims = (nx, ny, nz), each
    divisible by 2^(levels-1). Returns (meshes, per-level grid dims)."""
    nx, ny, nz = dims
    for n in dims:
        if n % (2 ** (levels - 1)):
            raise ValueError(f"dims {dims} are not divisible by 2^(levels-1) for {levels} levels")
    x0, x1, y0, y1, z0, z1 = bounds
    meshes = [
        box_mesh_tetrahedra(x0, x1, y0, y1, z0, z1, nx >> l, ny >> l, nz >> l)
        for l in range(levels)
    ]
    grid_dims = [(nx >> l, ny >> l, nz >> l) for l in range(levels)]
    return meshes, grid_dims


def structured_prolongation(n_f, n_c, dim: int):
    """P (fine x coarse) interpolation stencil for nested structured grids
    with prod(n+1) lexicographic nodes (x fastest, matching the mesh
    generators). ``n_f``/``n_c`` may be ints (isotropic) or per-axis
    tuples. Returns (idx (F, 2^dim), w (F, 2^dim)) padded with zero
    weights."""
    if np.isscalar(n_f):
        n_f = (n_f,) * dim
    if np.isscalar(n_c):
        n_c = (n_c,) * dim
    if not all(f == 2 * c for f, c in zip(n_f, n_c)):
        raise ValueError(f"grids are not 2:1 nested: {n_f} vs {n_c}")
    if dim == 2:
        jj, ii = np.meshgrid(np.arange(n_f[1] + 1), np.arange(n_f[0] + 1), indexing="ij")
        coords = np.stack([ii.reshape(-1), jj.reshape(-1)], axis=1)
    else:
        kk, jj, ii = np.meshgrid(
            np.arange(n_f[2] + 1),
            np.arange(n_f[1] + 1),
            np.arange(n_f[0] + 1),
            indexing="ij",
        )
        coords = np.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], axis=1)

    stencil = 2**dim
    n_fine = coords.shape[0]
    idx = np.zeros((n_fine, stencil), np.int32)
    w = np.zeros((n_fine, stencil), np.float64)

    def coarse_id(c):
        out = 0
        for ax in reversed(range(dim)):
            out = out * (n_c[ax] + 1) + c[ax]
        return out

    for f in range(n_fine):
        lo = coords[f] // 2
        frac = coords[f] - 2 * lo  # 0 or 1 per axis
        s = 0
        for corner in range(stencil):
            c = lo.copy()
            weight = 1.0
            ok = True
            for ax in range(dim):
                bit = (corner >> ax) & 1
                if frac[ax] == 0:
                    if bit == 1:
                        ok = False
                        break
                else:
                    c[ax] = lo[ax] + bit
                    weight *= 0.5
            if ok:
                idx[f, s] = coarse_id(c)
                w[f, s] = weight
                s += 1
    return idx, w


def prolongation_1d(n_c: int) -> np.ndarray:
    """Dense (2 n_c + 1, n_c + 1) 1D linear-interpolation prolongation:
    even fine node -> its coarse node, odd -> the two neighbours at 0.5
    each. ``structured_prolongation`` is the tensor product of these
    factors (Pz x Py x Px); fem/multigrid_batched.py::_prolong_tp applies
    them as three per-axis matrix products."""
    n_f = 2 * n_c
    p = np.zeros((n_f + 1, n_c + 1))
    c = np.arange(n_c + 1)
    p[2 * c, c] = 1.0
    p[2 * c[:-1] + 1, c[:-1]] = 0.5
    p[2 * c[:-1] + 1, c[:-1] + 1] = 0.5
    return p


def box_grid_dims(mesh) -> Optional[Tuple[int, int, int]]:
    """(nx+1, ny+1, nz+1) if ``mesh`` is a lexicographic 3D box grid
    (x fastest, as fem/mesh.py::_box_nodes lays it out), else None."""
    nodes = np.asarray(mesh.nodes)
    if nodes.ndim != 2 or nodes.shape[1] != 3:
        return None
    xs, ys, zs = (np.unique(nodes[:, a]) for a in range(3))
    if len(xs) * len(ys) * len(zs) != nodes.shape[0]:
        return None
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    ref = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    if not np.allclose(ref, nodes):
        return None
    return len(xs), len(ys), len(zs)


def transpose_transfer(p_idx, p_w, n_coarse: int):
    """Host-side transpose of a padded prolongation stencil: restriction
    R = P^T as a coarse-side gather (for each coarse node, the fine nodes
    it interpolates into and their weights) instead of a scatter-add.

    Returns (r_idx (N_c, K), r_w (N_c, K)) with zero-weight padding
    (padded index slots point at fine row 0)."""
    pi = np.asarray(p_idx)
    pw = np.asarray(p_w)
    nf, c = pi.shape
    fine = np.repeat(np.arange(nf, dtype=np.int64), c)
    coarse = pi.reshape(-1).astype(np.int64)
    wts = pw.reshape(-1)
    keep = wts != 0
    fine, coarse, wts = fine[keep], coarse[keep], wts[keep]
    order = np.argsort(coarse, kind="stable")
    fine, coarse, wts = fine[order], coarse[order], wts[order]
    counts = np.bincount(coarse, minlength=n_coarse)
    k_max = int(counts.max()) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(coarse.size) - starts[coarse]
    r_idx = np.zeros((n_coarse, k_max), np.int32)
    r_w = np.zeros((n_coarse, k_max), pw.dtype)
    r_idx[coarse, pos] = fine
    r_w[coarse, pos] = wts
    return r_idx, r_w


class MgLevel(NamedTuple):
    """One smoothing level. The value tables carry a trailing lane axis
    when the level was built for a band of wavenumbers."""

    ell_indices: torch.Tensor  # (N_l, W_l) int64
    ell_values: torch.Tensor  # (N_l, W_l) complex, or (N_l, W_l, F)
    inv_diag: torch.Tensor  # (N_l,) complex, or (N_l, F)
    p_idx: torch.Tensor  # (N_l, 2^d) prolongation from level l+1
    p_w: torch.Tensor  # (N_l, 2^d)
    r_idx: torch.Tensor  # (N_{l+1}, K) transposed (restriction) stencil
    r_w: torch.Tensor  # (N_{l+1}, K)


class MgParams(NamedTuple):
    levels: Tuple[MgLevel, ...]
    # Real-embedded explicit inverse (2Nc, 2Nc), shared by every lane; or
    # (G, 2Nc, 2Nc), lanes in G contiguous groups of F / G (G = F: one per
    # lane; G = anchors: one per anchor chunk).
    coarse_inv: torch.Tensor


class MgBuilderLevel(NamedTuple):
    """Per-level frequency-independent pieces (device tensors)."""

    k_vals: torch.Tensor
    m_vals: torch.Tensor
    b_sum: torch.Tensor  # summed tagged boundary-mass values (may be zeros)
    csr2ell: torch.Tensor
    ell_indices: torch.Tensor
    row_of_slot: torch.Tensor
    col_of_slot: torch.Tensor
    p_idx: torch.Tensor  # (N_l, 2^d) prolongation from level l+1; empty at the coarsest
    p_w: torch.Tensor
    r_idx: torch.Tensor  # (N_{l+1}, K) transposed (restriction) stencil
    r_w: torch.Tensor
    num_nodes: int


class MgBuilder(NamedTuple):
    levels: Tuple[MgBuilderLevel, ...]


class GeometricMultigrid:
    """Host-side factory: assembles each level once and emits an
    MgBuilder of device tensors; ``build_mg_params`` then builds the
    preconditioner for any wavenumber (or band of them)."""

    def __init__(
        self,
        meshes: Sequence[Mesh],
        robin_tags: Sequence[int] = (),
        dtype=None,
        grid_dims: Optional[Sequence] = None,
        *,
        device=None,
    ):
        """``grid_dims``: per-level (nx[, ny[, nz]]) cell counts for
        anisotropic grids; inferred as isotropic if omitted."""
        self.dtype = dtype or default_float()
        self.cdtype = complex_dtype_for(self.dtype)
        self.device = resolve_device(device)
        self.meshes = list(meshes)
        self.assemblers = [
            HelmholtzAssembler(m, robin_tags=tuple(robin_tags), dtype=self.dtype,
                               device=self.device)
            for m in self.meshes
        ]
        dev, dt = self.device, self.dtype
        lvls = []
        for l, asm in enumerate(self.assemblers):
            if l < len(self.meshes) - 1:
                dim = self.meshes[l].dim
                if grid_dims is not None:
                    n_f = tuple(grid_dims[l])
                    n_c = tuple(grid_dims[l + 1])
                else:
                    n_f = round(self.meshes[l].num_nodes ** (1 / dim)) - 1
                    n_c = round(self.meshes[l + 1].num_nodes ** (1 / dim)) - 1
                p_idx, p_w = structured_prolongation(n_f, n_c, dim)
                r_idx, r_w = transpose_transfer(p_idx, p_w, self.meshes[l + 1].num_nodes)
            else:
                p_idx = r_idx = np.zeros((0, 1), np.int32)
                p_w = r_w = np.zeros((0, 1))
            b_sum = (
                sum(asm.b_vals.values())
                if asm.b_vals
                else torch.zeros_like(asm.k_vals)
            )
            lvls.append(
                MgBuilderLevel(
                    asm.k_vals,
                    asm.m_vals,
                    b_sum,
                    asm.csr2ell,
                    asm.ell_indices,
                    asm.row_of_slot,
                    asm.col_of_slot,
                    torch.as_tensor(p_idx, dtype=torch.int64, device=dev),
                    torch.as_tensor(p_w, dtype=dt, device=dev),
                    torch.as_tensor(r_idx, dtype=torch.int64, device=dev),
                    torch.as_tensor(r_w, dtype=dt, device=dev),
                    asm.num_nodes,
                )
            )
        self.builder = MgBuilder(tuple(lvls))


def _wavenumbers(k, like):
    """``k`` as a real tensor on ``like``'s device: 0-d for one wavenumber,
    (F,) for a band."""
    if torch.is_tensor(k):
        return k.to(like.device)
    return torch.tensor(k, dtype=like.dtype, device=like.device)


def _coefficient(c, cd, device, shape):
    """A complex coefficient (a number or a tensor) broadcast to ``shape``."""
    c = c.to(device, cd) if torch.is_tensor(c) else torch.tensor(c, dtype=cd, device=device)
    return c.expand(shape)


def _shift_coefficients(like, k, robin_coeff, shift):
    """The complex coefficients (cm, cb) of K - cm M + cb B for the shift
    (b1, b2): cm = (b1 + i b2) k^2, cb = ``robin_coeff``; 0-d for one
    wavenumber, (F,) for a band."""
    b1, b2 = shift
    cd = complex_dtype_for(like.dtype)
    k = _wavenumbers(k, like)
    cm = torch.tensor(b1 + 1j * b2, dtype=cd, device=k.device) * (k**2).to(cd)
    return cm, _coefficient(robin_coeff, cd, k.device, k.shape)


def _level_values(bl: MgBuilderLevel, k, robin_coeff, shift):
    """CSR values of the shifted level operator: (nnz,) for one
    wavenumber, (F, nnz) for a band."""
    cm, cb = _shift_coefficients(bl.k_vals, k, robin_coeff, shift)
    return _combine(bl.k_vals, bl.m_vals, bl.b_sum, cm, cb).movedim(-1, 0)


def _combine(tk, tm, tb, cm, cb):
    """tk - cm tm + cb tb over frequency-shared real tables, with a
    trailing lane axis when cm/cb are (F,) bands."""
    cd = cm.dtype
    if cm.dim():
        tk, tm, tb = tk[..., None], tm[..., None], tb[..., None]
    return tk.to(cd) - cm * tm.to(cd) + cb * tb.to(cd)


def build_mg_levels(
    builder: MgBuilder,
    k,
    robin_coeff=0.0,
    shift: Tuple[float, float] = (1.0, 0.5),
) -> Tuple[MgLevel, ...]:
    """The ELL smoothing levels of the shifted preconditioner (everything
    but the coarse dense inverse).

    The k-independent ELL and diagonal tables of K, M and B are scattered
    once; the per-frequency values are one elementwise combine of them. A
    (F,) ``k`` (with a number or a (F,) ``robin_coeff``) gives per-lane
    tables with a trailing lane axis."""
    return tuple(_build_level(bl, k, robin_coeff, shift) for bl in builder.levels[:-1])


def _build_level(bl: MgBuilderLevel, k, robin_coeff, shift) -> MgLevel:
    ell_vals, inv_diag = _operator_tables(bl, k, robin_coeff, shift)
    return MgLevel(bl.ell_indices, ell_vals, inv_diag, bl.p_idx, bl.p_w, bl.r_idx, bl.r_w)


def _operator_tables(tables, k, robin_coeff, shift):
    """ELL values (N, W) and inverse diagonal (N,) of
    K - (b1 + i b2) k^2 M + robin_coeff B, with a trailing lane axis for a
    (F,) band. ``tables`` carries the real CSR values ``k_vals``,
    ``m_vals``, ``b_sum`` and their ELL/diagonal maps ``ell_indices``,
    ``csr2ell``, ``row_of_slot``, ``col_of_slot`` (an MgBuilderLevel, or
    the room model's RoomParams)."""
    cm, cb = _shift_coefficients(tables.k_vals, k, robin_coeff, shift)
    n_nodes, width = tables.ell_indices.shape

    def combined(scatter):
        return _combine(scatter(tables.k_vals), scatter(tables.m_vals), scatter(tables.b_sum),
                        cm, cb)

    ell_vals = combined(lambda v: scatter_ell(v, tables.csr2ell, n_nodes, width))
    diag = combined(lambda v: scatter_diag(v, tables.row_of_slot, tables.col_of_slot, n_nodes))
    return ell_vals, _safe_inverse(diag)


def _safe_inverse(diag):
    """1 / diag, and 1 where the diagonal vanishes."""
    return torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, torch.ones((), dtype=diag.dtype,
                                                                        device=diag.device))


def coarse_embedded(builder: MgBuilder, k, robin_coeff=0.0,
                    shift: Tuple[float, float] = (1.0, 0.5)):
    """(A, 2Nc, 2Nc) real-embedded dense coarsest shifted operators, one
    per wavenumber of ``k`` (A,), with boundary coefficients
    ``robin_coeff``: (A,) complex, or one value for all (default 0, no
    boundary term). A scalar ``k``, as the reference takes it, gives its
    one (2Nc, 2Nc) operator."""
    bl = builder.levels[-1]
    k = _wavenumbers(k, bl.k_vals)
    scalar = k.dim() == 0
    vals = _level_values(bl, k.reshape(-1), robin_coeff, shift)
    n_a, n = vals.shape[0], bl.num_nodes
    dense = torch.zeros((n_a, n, n), dtype=vals.dtype, device=vals.device)
    a_idx = torch.arange(n_a, device=vals.device)[:, None]
    dense.index_put_((a_idx, bl.row_of_slot.long()[None, :], bl.col_of_slot.long()[None, :]),
                     vals, accumulate=True)
    ar, ai = dense.real, dense.imag
    out = torch.cat([torch.cat([ar, -ai], dim=2), torch.cat([ai, ar], dim=2)], dim=1)
    return out[0] if scalar else out


def build_coarse_inv_chain(
    builder: MgBuilder,
    anchor_ks,
    robin_coeffs,
    shift: Tuple[float, float] = (1.0, 0.5),
    newton_steps: int = 3,
):
    """Explicit inverses for a *sorted* chain of anchor wavenumbers.

    Only the first is inverted directly; each inverse then seeds its
    neighbour's Newton-Schulz refinement X <- X (2I - A X). Every refined
    inverse is residual-checked (row-sum norm of I - A X, which bounds the
    spectral radius) and replaced by a direct inverse when the check
    fails. The JAX reference branches with ``lax.cond`` inside a scan;
    here the check is read on the host once per anchor, so the direct
    inverse is only paid for when refinement actually failed.

    ``anchor_ks``: (A,) ascending; ``robin_coeffs``: (A,) complex.
    Returns (A, 2Nc, 2Nc)."""
    a_batch = coarse_embedded(builder, anchor_ks, robin_coeffs, shift)
    eye = torch.eye(a_batch.shape[1], dtype=a_batch.dtype, device=a_batch.device)
    inverses = []
    with full_f32_matmul():  # true f32 products: no TF32 in the chain
        x = torch.linalg.inv(a_batch[0])
        for a_i in a_batch:
            for _ in range(newton_steps):
                x = x @ (2.0 * eye - a_i @ x)
            resid = torch.max(torch.sum(torch.abs(eye - a_i @ x), dim=1))
            if not bool(torch.isfinite(resid) & (resid < 0.1)):
                x = torch.linalg.inv(a_i)
            inverses.append(x)
    return torch.stack(inverses)


def build_coarse_inv(
    builder: MgBuilder,
    k,
    robin_coeff=0.0,
    shift: Tuple[float, float] = (1.0, 0.5),
):
    """Explicit real-embedded inverse of the coarsest shifted operator:
    (2Nc, 2Nc) for one wavenumber, (F, 2Nc, 2Nc) for a band (one direct
    inverse per lane)."""
    return torch.linalg.inv(coarse_embedded(builder, k, robin_coeff, shift))


def build_mg_params(
    builder: MgBuilder,
    k,
    robin_coeff=0.0,
    shift: Tuple[float, float] = (1.0, 0.5),
) -> MgParams:
    """MgParams for P = K - (b1 + i b2) k^2 M + robin_coeff B, for one
    wavenumber or per lane of a (F,) band."""
    return MgParams(
        build_mg_levels(builder, k, robin_coeff, shift),
        build_coarse_inv(builder, k, robin_coeff, shift),
    )


def _gather_sum(idx, w, x):
    """sum_s w[:, s] x[idx[:, s]], one stencil column at a time (no
    (N, S, F) intermediate); a weight table without ``x``'s lane axis is
    shared by every lane."""
    if w.dim() < x.dim() + 1:
        w = w[..., None]
    y = w[:, 0] * x[idx[:, 0]]
    for s in range(1, idx.shape[1]):
        y = y + w[:, s] * x[idx[:, s]]
    return y


def _level_matvec(level: MgLevel, x):
    return _gather_sum(level.ell_indices, level.ell_values, x)


def _prolong(level: MgLevel, xc):
    return _gather_sum(level.p_idx, level.p_w.to(xc.dtype), xc)


def _restrict(level: MgLevel, rf, n_coarse: int):
    """R = P^T as a coarse-side gather with the transposed stencil
    (transpose_transfer)."""
    del n_coarse  # shape comes from the transposed stencil
    return _gather_sum(level.r_idx, level.r_w.to(rf.dtype), rf)


def _embedded_solve(inv, r):
    """x = P_c^{-1} r through the real-embedded inverse ``inv``, in true
    float32 (no TF32) on the card: (2Nc, 2Nc) shared by every lane, or
    (G, 2Nc, 2Nc) with the lanes of r (Nc, F) in G contiguous groups."""
    n = inv.shape[-1] // 2
    b2 = torch.cat([r.real, r.imag])  # (2Nc,) or (2Nc, F)
    with full_f32_matmul():
        if inv.dim() == 2:
            x2 = inv.to(b2.dtype) @ b2
        else:
            groups, nf = inv.shape[0], b2.shape[1]
            b3 = b2.reshape(2 * n, groups, nf // groups).permute(1, 0, 2)
            x2 = torch.bmm(inv.to(b2.dtype), b3).permute(1, 0, 2).reshape(2 * n, nf)
    return torch.complex(x2[:n], x2[n:]).to(r.dtype)


def _coarse_solve(mgp: MgParams, r):
    return _embedded_solve(mgp.coarse_inv, r)


def mg_cycle(
    mgp: MgParams,
    r,
    omega: float = 2.0 / 3.0,
    nu: int = 2,
    level: int = 0,
    cycle: str = "v",
    nu_post: Optional[int] = None,
):
    """One multigrid cycle x ~ P^{-1} r: 'v' (one coarse visit), 'w' (two
    recursive visits) or 'f' (an F visit, then a V visit), damped Jacobi
    smoothing, ``nu`` pre- and ``nu_post`` (default ``nu``) post-smoothing
    steps; ``nu=0`` skips pre-smoothing (the coarse grid corrects r).
    ``r`` is (N,) or a node-major band (N, F) (see the module notes)."""
    if cycle not in ("v", "w", "f"):
        raise ValueError(f"unknown multigrid cycle type {cycle!r}; expected 'v', 'w' or 'f'")
    if level == len(mgp.levels):
        return _coarse_solve(mgp, r)
    if nu_post is None:
        nu_post = nu
    lvl = mgp.levels[level]
    om = torch.tensor(omega, dtype=r.dtype, device=r.device)
    inv_diag = lvl.inv_diag
    if inv_diag.dim() < r.dim():  # a frequency-shared level on a band
        inv_diag = inv_diag[..., None]
    if nu == 0:  # V(0, nu_post): no pre-smoothing, coarse sees r itself
        x = torch.zeros_like(r)
        res = r
    else:
        x = om * inv_diag * r  # first smoothing step from x = 0
        for _ in range(nu - 1):
            x = x + om * inv_diag * (r - _level_matvec(lvl, x))
        res = r - _level_matvec(lvl, x)
    n_coarse = (
        mgp.levels[level + 1].ell_indices.shape[0]
        if level + 1 < len(mgp.levels)
        else mgp.coarse_inv.shape[-1] // 2
    )
    rc = _restrict(lvl, res, n_coarse)
    xc = mg_cycle(mgp, rc, omega, nu, level + 1, cycle, nu_post)
    if cycle in ("w", "f") and level + 1 < len(mgp.levels):
        # second coarse visit on the updated residual (W: same cycle type;
        # F: a V-cycle); skipped when the next level is the exact solve
        rc2 = rc - _level_matvec(mgp.levels[level + 1], xc)
        second = "v" if cycle == "f" else "w"
        xc = xc + mg_cycle(mgp, rc2, omega, nu, level + 1, second, nu_post)
    x = x + _prolong(lvl, xc)
    for _ in range(nu_post):
        x = x + om * inv_diag * (r - _level_matvec(lvl, x))
    return x


def vcycle(mgp: MgParams, r, omega: float = 2.0 / 3.0, nu: int = 2, level: int = 0,
           nu_post: Optional[int] = None):
    """One multigrid V-cycle; see mg_cycle for W/F."""
    return mg_cycle(mgp, r, omega, nu, level, "v", nu_post)


def solve_multigrid(
    mgp: MgParams, b, tol: float = 1e-8, max_cycles: int = 50, cycle: str = "v"
):
    """Stand-alone MG solve of one system by repeated cycles, for an
    MG-amenable (shifted or damped) operator. The reference's while loop
    reads its condition on the host once per cycle. Returns (x, cycles)."""
    b_norm = float(torch.linalg.vector_norm(b))
    x = torch.zeros_like(b)
    r = b
    i = 0
    while i < max_cycles and float(torch.linalg.vector_norm(r)) > tol * b_norm:
        x = x + mg_cycle(mgp, r, cycle=cycle)
        r = b - _level_matvec(mgp.levels[0], x)
        i += 1
    return x, torch.tensor(i, dtype=torch.int32, device=b.device)
