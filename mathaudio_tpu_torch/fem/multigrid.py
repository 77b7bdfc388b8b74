"""Geometric multigrid, host half + coarse inverses (counterpart of
mathaudio_tpu/fem/multigrid.py:40-297, 356-432).

Nested box hierarchies by factor-2 coarsening; transfers are exact
multilinear interpolation stencils (padded gather tables); the coarsest
complex shifted operator P = K - (b1 + i b2) k^2 M + c B is applied
through a real-embedded explicit inverse, one per frequency anchor,
chained by Newton-Schulz refinement.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mathaudio_tpu_torch.fem.assembly import HelmholtzAssembler
from mathaudio_tpu_torch.fem.mesh import Mesh, box_mesh_tetrahedra
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


class MgBuilderLevel(NamedTuple):
    """Per-level frequency-independent pieces (device tensors)."""

    k_vals: torch.Tensor
    m_vals: torch.Tensor
    b_sum: torch.Tensor  # summed tagged boundary-mass values (may be zeros)
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
    MgBuilder of device tensors."""

    def __init__(
        self,
        meshes: Sequence[Mesh],
        robin_tags: Sequence[int] = (),
        dtype=None,
        grid_dims: Optional[Sequence] = None,
        *,
        device=None,
    ):
        """Isotropic box hierarchies (each level's grid size is inferred
        from its node count). The reference's ``grid_dims`` (anisotropic
        grids) comes with the single-vector multigrid of slice 6."""
        if grid_dims is not None:
            raise ValueError(
                "GeometricMultigrid(grid_dims=...) (anisotropic grids) is not ported yet: it "
                "comes with slice 6 of the port; leave it None for isotropic box hierarchies"
            )
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


def coarse_embedded(builder: MgBuilder, k, robin_coeff=0.0,
                    shift: Tuple[float, float] = (1.0, 0.5)):
    """(A, 2Nc, 2Nc) real-embedded dense coarsest shifted operators, one
    per wavenumber of ``k`` (A,), with boundary coefficients
    ``robin_coeff``: (A,) complex, or one value for all (default 0, no
    boundary term). A scalar ``k``, as the reference takes it, gives its
    one (2Nc, 2Nc) operator."""
    bl = builder.levels[-1]
    b1, b2 = shift
    cd = complex_dtype_for(bl.k_vals.dtype)
    dev = bl.k_vals.device
    k = k.to(dev) if torch.is_tensor(k) else torch.tensor(k, dtype=bl.k_vals.dtype, device=dev)
    scalar = k.dim() == 0
    k = k.reshape(-1)
    robin = (robin_coeff.to(dev, cd) if torch.is_tensor(robin_coeff)
             else torch.tensor(robin_coeff, dtype=cd, device=dev))
    robin = robin.reshape(-1).expand(k.shape[0])
    zshift = torch.tensor(b1 + 1j * b2, dtype=cd, device=dev)
    vals = (
        bl.k_vals.to(cd)[None, :]
        - (zshift * (k**2).to(cd))[:, None] * bl.m_vals.to(cd)[None, :]
        + robin[:, None] * bl.b_sum.to(cd)[None, :]
    )
    n_a, n = vals.shape[0], bl.num_nodes
    dense = torch.zeros((n_a, n, n), dtype=cd, device=vals.device)
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
