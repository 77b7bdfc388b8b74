"""Dense collocation assembly over a band of wavenumbers (counterpart of
mathaudio_tpu/bem/assembly.py: the pair kernels, the self-element
angular rule and the regularised row assembly of the frequency sweep).

Exterior Neumann (rigid) boundary integral equation, time convention
e^{-i omega t}, G = e^{ikr}/(4 pi r), normals pointing into the fluid:

    (1/2) p(x) - D[p](x) = p_inc(x)                     (CBIE)
    T[p](x) = -dp_inc/dn(x)                             (HBIE)

Burton–Miller combines A = (1/2)I - D + beta T, b = p_inc - beta dp_inc/dn.
One fixed Gauss rule covers all pairs; the singular self terms are
replaced by exact static row sums and analytic radial integrals:

    D_ii = -1/2 - sum_{j != i} D_0[i, j]
    T_ii = (1/4pi) sum_phi w_phi (ik - (e^{ikR} - 1)/R) - sum_{j != i} T_0[i, j]

where R(phi) is the centroid-to-edge distance along direction phi.

Every function here takes the band ``ks`` (F,) and ``betas`` (F,) and
returns (F, R, N) blocks: the reference's ``vmap`` over wavenumbers is
the leading batch dimension.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mathaudio_tpu_torch.bem.mesh import SurfaceMesh
from mathaudio_tpu_torch.fem.quadrature import gauss_1d
from mathaudio_tpu_torch.ops.bem_assembly import pairwise_bm, pairwise_double_layer
from mathaudio_tpu_torch.xtypes import complex_dtype_for


def _pair_kernels(x, nx, y, ny, k):
    """dG/dn_y and true hypersingular n_x.grad_x(n_y.grad_y G) for
    broadcastable point sets x (..., 3), y (..., 3); ``k`` a float or a
    real tensor broadcasting against the pair shape (e.g. (F, 1, 1))."""
    rv = y - x
    r2 = torch.sum(rv * rv, dim=-1)
    r = torch.sqrt(r2)
    rs = torch.where(r < 1e-15, 1.0, r)
    cd = complex_dtype_for(r.dtype)
    k = torch.as_tensor(k, dtype=r.dtype, device=r.device)
    g = torch.exp(1j * (k * rs).to(cd)) / (4.0 * math.pi * rs)
    ik = (1j * k).to(cd)
    r_dot_ny = torch.sum(rv * ny, dim=-1)
    r_dot_nx = torch.sum(rv * nx, dim=-1)
    nx_dot_ny = torch.sum(nx * ny, dim=-1)
    dg_dny = (ik - 1.0 / rs) * g * r_dot_ny / rs
    coef1 = ik * ik - 3.0 * ik / rs + 3.0 / r2.clip(1e-30)
    term1 = coef1 * r_dot_nx * r_dot_ny / rs**2
    term2 = (ik - 1.0 / rs) * nx_dot_ny / rs
    hyper = -(term1 + term2) * g
    return dg_dny, hyper


def _static_pair_kernels(x, nx, y, ny):
    """k = 0 (Laplace) limits of the pair kernels."""
    rv = y - x
    r2 = torch.sum(rv * rv, dim=-1)
    r = torch.sqrt(r2)
    rs = torch.where(r < 1e-15, 1.0, r)
    g0 = 1.0 / (4.0 * math.pi * rs)
    r_dot_ny = torch.sum(rv * ny, dim=-1)
    r_dot_nx = torch.sum(rv * nx, dim=-1)
    nx_dot_ny = torch.sum(nx * ny, dim=-1)
    dg0 = -g0 * r_dot_ny / rs**2
    hyp0 = -g0 * (3.0 * r_dot_nx * r_dot_ny / rs**4 - nx_dot_ny / rs**2)
    return dg0, hyp0


def _self_angular_rule(mesh: SurfaceMesh, n_ang: int = 12):
    """Angular quadrature around each centroid: per element, per edge,
    Gauss points in the vertex-angle sector with exact edge distance
    R(phi). Returns (R (N, nv*n_ang), w (N, nv*n_ang)) host arrays."""
    pts = mesh.nodes[mesh.elements]  # (N, nv, 3)
    nv = pts.shape[1]
    c = mesh.centers  # (N, 3)
    n = mesh.normals
    # local in-plane orthonormal basis
    e1 = pts[:, 0] - c
    e1 = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(n, e1)
    v2d = np.stack(
        [
            np.einsum("nd,nvd->nv", e1, pts - c[:, None, :]),
            np.einsum("nd,nvd->nv", e2, pts - c[:, None, :]),
        ],
        axis=-1,
    )  # (N, nv, 2)
    gx, gw = gauss_1d(n_ang)
    radii = []
    weights = []
    for e in range(nv):
        a = v2d[:, e]  # (N, 2)
        b = v2d[:, (e + 1) % nv]
        phi_a = np.arctan2(a[:, 1], a[:, 0])
        phi_b = np.arctan2(b[:, 1], b[:, 0])
        dphi = np.mod(phi_b - phi_a, 2 * np.pi)  # sector sweep a -> b (ccw)
        # edge line: n_e . y = h with unit normal n_e, h > 0
        t = b - a
        n_e = np.stack([t[:, 1], -t[:, 0]], axis=1)
        n_e /= np.linalg.norm(n_e, axis=1, keepdims=True)
        h = np.einsum("nd,nd->n", n_e, a)
        flip = h < 0
        n_e[flip] *= -1.0
        h = np.abs(h)
        for q in range(n_ang):
            phi = phi_a + (gx[q] + 1.0) / 2.0 * dphi
            d = np.stack([np.cos(phi), np.sin(phi)], axis=1)
            denom = np.einsum("nd,nd->n", n_e, d)
            r_phi = h / np.maximum(denom, 1e-12)
            radii.append(r_phi)
            weights.append(gw[q] / 2.0 * dphi)
    radii = np.stack(radii, axis=1)  # (N, nv*n_ang)
    weights = np.stack(weights, axis=1)
    return radii, weights


def _assemble_rows(x_c, x_n, row0, sr, sw, normals, qp, qw, ks, betas, with_bm):
    """(F, R, N) block of A for the R collocation rows ``row0 ..
    row0 + R - 1`` (centers x_c, normals x_n, self rule sr/sw).

    Every regularisation term is row-local, so the assembly tiles over
    rows. The epilogue works in place on the pairwise sums: the off-
    diagonal entries are -D_k (+ beta T_k), which is what the reference's
    ((D_k - D_0) + D_0) and ((T_k - T_0) + T_0) leave off the diagonal,
    and the diagonal is written through a diagonal view, never by a 0/1
    mask: the pairwise i == j entries are singular (inf in float32 for
    Burton–Miller) and 0 * inf would be NaN. No (R, N) one-hot mask and no
    second (F, R, N) buffer exist."""
    cd = complex_dtype_for(x_c.dtype)
    rows = x_c.shape[0]

    def diagonal(t):
        """View of the block's diagonal entries (i, row0 + i), shape (..., R)."""
        return torch.diagonal(t[..., row0:row0 + rows], dim1=-2, dim2=-1)

    if with_bm:
        dk, d0s, tk, t0s = pairwise_bm(x_c, x_n, qp, normals, qw, ks)
    else:
        dk, d0s = pairwise_double_layer(x_c, qp, normals, qw, ks)

    # --- double layer D (regularised; exact static row sums)
    diagonal(d0s).zero_()
    d_diag = -0.5 - torch.sum(d0s, dim=1)  # exact -1/2 row sum
    a_diag = (0.5 - d_diag).to(cd)  # (R,)
    if with_bm:
        diagonal(t0s).zero_()
        t0_diag = -torch.sum(t0s, dim=1)  # exact zero row sum
        # analytic radial self term of (T_k - T_0):
        # (1/4pi) sum w [ik - (e^{ikR} - 1)/R]
        ik = (1j * ks.to(x_c.dtype)).to(cd)[:, None, None]
        rr = sr.to(cd)
        t_self = torch.sum(sw.to(cd) * (ik - (torch.exp(ik * rr) - 1.0) / rr), dim=-1) / (4.0 * math.pi)
        a_diag = a_diag + betas[:, None] * (t_self + t0_diag.to(cd))  # (F, R)
        a = tk.mul_(betas[:, None, None]).sub_(dk)  # -D_k + beta T_k in T_k's buffer
    else:
        a = dk.neg_()
    diagonal(a).copy_(a_diag.expand(a.shape[0], rows))
    return a


def _auto_row_block(n: int, nq: int) -> int:
    """Row-chunk size: keep the (R, N, nq) complex kernel buffers near
    256 MB so dense assembly scales to N > 20k."""
    if n <= 2048:
        return n
    budget = 256 * 1024 * 1024
    r = max(64, budget // (n * max(nq, 1) * 16))
    return int(min(n, 1 << (r.bit_length() - 1)))


def _assemble(centers, normals, qp, qw, self_r, self_w, ks, betas, with_bm, row_block=0):
    """(F, N, N) regularised collocation matrices for the band ``ks``
    (counterpart of the reference's ``_assemble_jit``):

    D = (D_k - D_0) + D_0  with  sum_j D_0[i, j] = -1/2 exactly,
    T = (T_k - T_0) + T_0  with  sum_j T_0[i, j] = 0 exactly.

    ``row_block > 0`` assembles (F, row_block, N) row chunks in a loop
    into the output, so only chunk-sized pairwise sums exist at once; the
    last chunk is ragged (the reference pads it)."""
    n = centers.shape[0]
    if row_block <= 0 or row_block >= n:
        return _assemble_rows(centers, normals, 0, self_r, self_w, normals, qp, qw, ks,
                              betas, with_bm)
    out = torch.empty((ks.shape[0], n, n), dtype=complex_dtype_for(centers.dtype),
                      device=centers.device)
    for r0 in range(0, n, row_block):
        r1 = min(n, r0 + row_block)
        out[:, r0:r1] = _assemble_rows(centers[r0:r1], normals[r0:r1], r0, self_r[r0:r1],
                                       self_w[r0:r1], normals, qp, qw, ks, betas, with_bm)
    return out
