"""Dense collocation assembly (counterpart of mathaudio_tpu/bem/assembly.py:
the pair kernels, the self-element angular rule, the regularised row
assembly over a band of wavenumbers, the single-k rigid, Burton–Miller and
mixed velocity/pressure systems, and the near-pair quadrature upgrade).

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

The sweep's functions (``_assemble_rows``, ``_assemble``) take the band
``ks`` (F,) and ``betas`` (F,) and return (F, R, N) blocks: the
reference's ``vmap`` over wavenumbers is the leading batch dimension. The
single-k entry points (``assemble_collocation_matrix``,
``assemble_burton_miller``, ``assemble_mixed_system``) return (N, N).

Mixed velocity/pressure boundary conditions (exterior, e^{-i omega t},
outgoing G, q = dp/dn):

    CBIE:  (1/2) p - D[p] + S[q] = p_inc
    HBIE:  (1/2) q - T[p] + K'[q] = dp_inc/dn

combined as CBIE - beta HBIE:

    Ap = 1/2 I - D + beta T        (coefficients of p)
    Aq = S - beta (1/2 I + K')     (coefficients of q)

with the single-layer self term S_ii = (1/4pi) sum_phi w_phi
(e^{ikR} - 1)/(ik). A velocity element's column comes from Ap and its
prescribed q moves to the right-hand side through Aq; a pressure element
the other way round.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mathaudio_tpu_torch.bem.mesh import SurfaceMesh
from mathaudio_tpu_torch.fem.quadrature import gauss_1d
from mathaudio_tpu_torch.ops.bem_assembly import pairwise_bm, pairwise_double_layer, pairwise_mixed
from mathaudio_tpu_torch.utils.profiling import count, region
from mathaudio_tpu_torch.xtypes import (
    complex_dtype_for,
    default_float,
    real_dtype_for,
    resolve_device,
)


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
    last chunk is ragged (the reference pads it). The assembly is the
    region ``bem.assemble``; ``bem.row_chunks`` counts its chunks (1 in
    one shot)."""
    n = centers.shape[0]
    with region("bem.assemble"):
        if row_block <= 0 or row_block >= n:
            count("bem.row_chunks")
            return _assemble_rows(centers, normals, 0, self_r, self_w, normals, qp, qw, ks,
                                  betas, with_bm)
        out = torch.empty((ks.shape[0], n, n), dtype=complex_dtype_for(centers.dtype),
                          device=centers.device)
        for r0 in range(0, n, row_block):
            r1 = min(n, r0 + row_block)
            count("bem.row_chunks")
            out[:, r0:r1] = _assemble_rows(centers[r0:r1], normals[r0:r1], r0, self_r[r0:r1],
                                           self_w[r0:r1], normals, qp, qw, ks, betas, with_bm)
        return out


# Real output planes the pairwise kernel writes per (i, j) pair at F = 1.
_PLANES = {"double_layer": 3, "burton_miller": 6, "mixed": 5, "mixed_bm": 10, "kh": 4,
           "kh_double": 2}
_ONE_SHOT_BYTES = 4 * 1024**3


def _resolve_row_block(row_block, n: int, nq: int, like: torch.Tensor, variant: str,
                       rows=None) -> int:
    """Rows per chunk of ``rows`` points (default N, the surface's own)
    against N elements. An explicit ``row_block`` is taken as it is. None
    sizes it: on the CPU as the reference does (every row up to N = 2048,
    else ``_auto_row_block``); on the GPU, where the kernel holds no
    (R, N, nq) buffer, by the pairwise planes alone: one shot while they
    fit 4 GiB, else the largest power of two of rows that does."""
    if row_block is not None:
        return int(row_block)
    if like.device.type != "cuda":
        return _auto_row_block(n, nq)
    rows = n if rows is None else rows
    fit = _ONE_SHOT_BYTES // (n * _PLANES[variant] * like.element_size())
    return rows if fit >= rows else max(64, 1 << (int(fit).bit_length() - 1))


def _mesh_tensors(mesh: SurfaceMesh, quad_order: int, dtype, device):
    """(centers, normals, qp, qw, self_r, self_w) of ``mesh`` on ``device``."""
    qp, qw = mesh.quad_points(quad_order)
    self_r, self_w = _self_angular_rule(mesh)
    return tuple(torch.tensor(a, dtype=dtype, device=device)
                 for a in (mesh.centers, mesh.normals, qp, qw, self_r, self_w))


# ---------------------------------------------------------------------------
# Near-pair quadrature upgrade: the fixed Gauss rule carries ~9% entry error
# on edge-adjacent pairs at quad_order 3. The small set of near pairs is
# recomputed with a subdivided rule and the difference added to the
# assembled matrix, keeping the exact static row sums on the diagonal.


def _near_pairs(mesh: SurfaceMesh, near_factor: float = 2.0):
    """(pi, pj) index arrays of ordered element pairs whose center
    distance is below near_factor * mean element size (both directions,
    diagonal excluded). O(N) pairs via a KD-tree (host)."""
    from scipy.spatial import cKDTree

    sizes = np.sqrt(mesh.areas)
    tree = cKDTree(mesh.centers)
    pairs = tree.query_pairs(float(near_factor * sizes.max()), output_type="ndarray")
    if len(pairs) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    d = np.linalg.norm(mesh.centers[pairs[:, 0]] - mesh.centers[pairs[:, 1]], axis=1)
    keep = d < near_factor * 0.5 * (sizes[pairs[:, 0]] + sizes[pairs[:, 1]])
    pairs = pairs[keep]
    pi = np.concatenate([pairs[:, 0], pairs[:, 1]])
    pj = np.concatenate([pairs[:, 1], pairs[:, 0]])
    return pi, pj


def _near_delta(xc, xn, qpc, qwc, qpf, qwf, ny, k, beta, with_bm):
    """Corrections for the near pairs [pi, pj]: (refined - coarse)
    quadrature deltas, as (delta_off, delta_diag); delta_off applies to
    A[pi, pj] and delta_diag to A[pi, pi]. The diagonal term keeps the exact
    static row sums (sum_j D0 = -1/2, sum_j T0 = 0) that the assembly
    enforces: correcting the off-diagonal static entries without
    rebalancing the diagonal degrades accuracy, since the row sums were
    absorbing exactly that error. Inputs are (P, ...) tensors per pair."""
    cd = complex_dtype_for(xc.dtype)
    bx = xc[:, None, :]
    bnx = xn[:, None, :]
    bny = ny[:, None, :]

    def sums(y, w):
        dg, hyp = _pair_kernels(bx, bnx, y, bny, k)
        dg0, hyp0 = _static_pair_kernels(bx, bnx, y, bny)
        wd = w.to(cd)
        return (torch.sum(dg * wd, dim=-1), torch.sum(dg0 * w, dim=-1),
                torch.sum(hyp * wd, dim=-1) if with_bm else None,
                torch.sum(hyp0 * w, dim=-1) if with_bm else None)

    df, d0f, tf, t0f = sums(qpf, qwf)
    dc, d0c, tc, t0c = sums(qpc, qwc)
    delta_off = -(df - dc)
    delta_diag = (d0f - d0c).to(cd)  # D0 row sum stays exactly -1/2
    if with_bm:
        delta_off = delta_off + beta * (tf - tc)
        delta_diag = delta_diag - beta * (t0f - t0c).to(cd)  # T0 row sum stays 0
    return delta_off, delta_diag


def apply_near_pair_upgrade(a, mesh: SurfaceMesh, k: float, beta: complex = 0.0,
                            quad_order: int = 3, near_factor: float = 2.0, depth: int = 2,
                            dtype=None, with_bm=None):
    """Return a copy of ``a`` with its near-pair entries recomputed under the
    subdivided rule (triangles only; quads return ``a`` itself), on ``a``'s
    device. ``dtype`` is the real precision of the pair
    sums (default ``a``'s); ``with_bm`` defaults to ``beta != 0``. The
    pair list is host numpy (``_near_pairs``); the element points and
    weights move to the device once and are gathered there per pair."""
    if mesh.nodes_per_element != 3:
        return a
    dtype = dtype or real_dtype_for(a.dtype)
    if with_bm is None:
        with_bm = beta != 0.0
    pi, pj = _near_pairs(mesh, near_factor)
    if len(pi) == 0:
        return a
    dev = a.device
    qpc, qwc = mesh.quad_points(quad_order)
    qpf, qwf = mesh.quad_points_refined(quad_order, depth)
    pi_d = torch.as_tensor(pi, device=dev)
    pj_d = torch.as_tensor(pj, device=dev)

    def per(arr, idx):
        return torch.as_tensor(arr, dtype=dtype, device=dev)[idx]

    delta_off, delta_diag = _near_delta(
        per(mesh.centers, pi_d), per(mesh.normals, pi_d), per(qpc, pj_d), per(qwc, pj_d),
        per(qpf, pj_d), per(qwf, pj_d), per(mesh.normals, pj_d), k, beta, with_bm)
    a = a.index_put((pi_d, pj_d), delta_off.to(a.dtype), accumulate=True)
    return a.index_put_((pi_d, pi_d), delta_diag.to(a.dtype), accumulate=True)


def assemble_collocation_matrix(mesh: SurfaceMesh, k: float, quad_order: int = 3, dtype=None,
                                row_block=None, device=None):
    """(1/2)I - D: plain CBIE collocation matrix (N, N) complex, on
    ``device`` (default ``cuda``; raises without a GPU). ``row_block``:
    rows per assembly chunk (None sizes it, see ``_resolve_row_block``)."""
    dtype = dtype or default_float()
    t = _mesh_tensors(mesh, quad_order, dtype, resolve_device(device))
    ks = torch.tensor([k], dtype=dtype, device=t[0].device)
    betas = torch.zeros(1, dtype=complex_dtype_for(dtype), device=t[0].device)
    rb = _resolve_row_block(row_block, mesh.num_elements, t[2].shape[1], t[0], "double_layer")
    return _assemble(*t, ks, betas, False, rb)[0]


def assemble_burton_miller(mesh: SurfaceMesh, k: float, beta: complex, quad_order: int = 3,
                           dtype=None, row_block=None, device=None):
    """(1/2)I - D + beta T: Burton–Miller collocation matrix (N, N)."""
    dtype = dtype or default_float()
    t = _mesh_tensors(mesh, quad_order, dtype, resolve_device(device))
    ks = torch.tensor([k], dtype=dtype, device=t[0].device)
    betas = torch.tensor([beta], dtype=complex_dtype_for(dtype), device=t[0].device)
    rb = _resolve_row_block(row_block, mesh.num_elements, t[2].shape[1], t[0], "burton_miller")
    return _assemble(*t, ks, betas, True, rb)[0]


def _self_sums(sr, sw, k: float):
    """Analytic radial self terms per row: (S_ii, the self term of
    T_k - T_0) = (1/4pi) sum_phi w ((e^{ikR} - 1)/(ik), ik - (e^{ikR} - 1)/R)."""
    cd = complex_dtype_for(sr.dtype)
    ik = 1j * k
    rr, ww = sr.to(cd), sw.to(cd)
    e1 = torch.exp(ik * rr) - 1.0
    s_self = torch.sum(ww * e1 / ik, dim=1) / (4.0 * math.pi)
    t_self = torch.sum(ww * (ik - e1 / rr), dim=1) / (4.0 * math.pi)
    return s_self, t_self


def _mixed_rows(x_c, x_n, row0, sr, sw, normals, qp, qw, k, beta, unknown_p, p_known,
                q_known, adm, rhs_inc_rows, with_bm):
    """(R, N) block of the mixed system and its right-hand-side rows, for
    the collocation rows ``row0 .. row0 + R - 1``.

    The quadrature sums come from ``pairwise_mixed`` (the hand-written
    kernel on the GPU); this function does the row-local regularisation,
    the self terms and the BC column combination, in place in the sums'
    buffers: Ap is built in T_k's buffer (D_k's without Burton–Miller), Aq
    in S_k's, and A in Ap's, so no further (R, N) tensor exists. The
    singular i == j sums (inf in float32 for T_k) are never multiplied by
    a mask: the static planes' diagonals are zeroed through a diagonal
    view before the row sums, and the diagonals of Ap and Aq are written
    through the view."""
    cd = complex_dtype_for(x_c.dtype)
    rows = x_c.shape[0]
    ik = 1j * k

    def diagonal(t):
        """View of the block's diagonal entries (i, row0 + i), shape (R,)."""
        return torch.diagonal(t[..., row0:row0 + rows], dim1=-2, dim2=-1)

    ks = torch.tensor([k], dtype=x_c.dtype, device=x_c.device)
    dk, d0s, sk, tk, t0s, kpk = pairwise_mixed(x_c, x_n, qp, normals, qw, ks, with_bm)
    s_self, t_self = _self_sums(sr, sw, k)

    # Ap = 1/2 I - D (+ beta T): regularised as in _assemble_rows
    diagonal(d0s).zero_()
    ap_diag = (1.0 + torch.sum(d0s, dim=1)).to(cd)  # 1/2 - (-1/2 - sum_j D_0)
    aq_diag = s_self
    if with_bm:
        diagonal(t0s).zero_()
        ap_diag = ap_diag + beta * (t_self - torch.sum(t0s, dim=1).to(cd))
        ap = tk[0].mul_(beta).sub_(dk[0])
        # Aq = S - beta (1/2 I + K'); the flat-element self term of K' is 0
        aq = sk[0].sub_(kpk[0].mul_(beta))
        aq_diag = aq_diag - 0.5 * beta
    else:
        ap = dk[0].neg_()
        aq = sk[0]
    diagonal(ap).copy_(ap_diag)
    diagonal(aq).copy_(aq_diag)

    # Surface admittance couples q back to the unknown p on velocity
    # elements: q = i omega rho v_n - i k adm p, so the -ik adm part of the
    # q coefficient lands in the p column.
    m = unknown_p.to(cd)  # 1 where p is the unknown (velocity BC)
    b = rhs_inc_rows - aq @ (q_known * m) - ap @ (p_known * (1.0 - m))
    # a = (ap + aq (-ik adm)) m + aq (1 - m), column by column, in place
    ap.mul_(m[None, :])
    aq.mul_(((-ik * adm) * m + (1.0 - m))[None, :])
    return ap.add_(aq), b


def _assemble_mixed(centers, normals, qp, qw, self_r, self_w, k, beta, unknown_p, p_known,
                    q_known, adm, rhs_inc, with_bm, row_block=0):
    """(A (N, N), b (N,)) of the mixed system; ``row_block > 0`` assembles
    (row_block, N) row chunks in a loop into the outputs, the last chunk
    ragged (the reference pads it)."""
    n = centers.shape[0]
    if row_block <= 0 or row_block >= n:
        return _mixed_rows(centers, normals, 0, self_r, self_w, normals, qp, qw, k, beta,
                           unknown_p, p_known, q_known, adm, rhs_inc, with_bm)
    cd = complex_dtype_for(centers.dtype)
    a = torch.empty((n, n), dtype=cd, device=centers.device)
    b = torch.empty((n,), dtype=cd, device=centers.device)
    for r0 in range(0, n, row_block):
        r1 = min(n, r0 + row_block)
        a[r0:r1], b[r0:r1] = _mixed_rows(
            centers[r0:r1], normals[r0:r1], r0, self_r[r0:r1], self_w[r0:r1], normals, qp, qw,
            k, beta, unknown_p, p_known, q_known, adm, rhs_inc[r0:r1], with_bm)
    return a, b


def bc_vectors(bc, k: float, density: float, speed_of_sound: float, cd, device):
    """(unknown_p bool (N,), p_known, q_known, adm) of a BoundaryCondition
    as tensors: prescribed velocities become dp/dn = i omega rho v_n
    (e^{-i omega t}); ``adm`` is zero without an admittance."""
    bc_types = np.asarray(bc.types, np.int32)
    bc_values = np.asarray(bc.values, complex)
    n = bc_types.shape[0]
    if bc_values.shape != (n,):
        raise ValueError(f"boundary values have shape {bc_values.shape}, expected ({n},)")
    omega = k * speed_of_sound
    q_known = np.where(bc_types == 0, 1j * omega * density * bc_values, 0.0)
    p_known = np.where(bc_types == 1, bc_values, 0.0)
    adm = getattr(bc, "admittance", None)
    adm = np.zeros(n, complex) if adm is None else np.broadcast_to(np.asarray(adm, complex), (n,))

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=cd, device=device)

    return (torch.tensor(bc_types == 0, device=device), tensor(p_known), tensor(q_known),
            tensor(adm))


def assemble_mixed_system(mesh: SurfaceMesh, k: float, bc, beta: complex = 0.0, incident=None,
                          quad_order: int = 4, density: float = 1.204,
                          speed_of_sound: float = 343.0, dtype=None, row_block=None,
                          device=None):
    """Dense BEM system for per-element velocity/pressure BCs, on
    ``device`` (default ``cuda``; raises without a GPU).

    Returns (A, b, unknown_p) where the solution vector of A u = b holds
    the surface pressure on velocity elements and dp/dn on pressure
    elements (``unknown_p``, a numpy bool array, marks which).
    ``incident=None`` is a pure radiation problem; with an incident field
    the unknowns are total-field quantities. Burton–Miller runs when
    ``beta != 0``."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    cd = complex_dtype_for(dtype)
    n = mesh.num_elements
    if np.shape(bc.types) != (n,):
        raise ValueError(f"boundary types have shape {np.shape(bc.types)}, expected ({n},)")
    unknown_p, p_known, q_known, adm = bc_vectors(bc, k, density, speed_of_sound, cd, device)
    centers, normals, qp, qw, self_r, self_w = _mesh_tensors(mesh, quad_order, dtype, device)
    with_bm = beta != 0.0
    if incident is not None:
        rhs_inc = incident.pressure(centers, k)
        if with_bm:
            rhs_inc = rhs_inc - beta * incident.normal_derivative(centers, normals, k)
    else:
        rhs_inc = torch.zeros(n, dtype=cd, device=device)
    rb = _resolve_row_block(row_block, n, qp.shape[1], centers,
                            "mixed_bm" if with_bm else "mixed")
    a, b = _assemble_mixed(centers, normals, qp, qw, self_r, self_w, k, beta, unknown_p,
                           p_known, q_known, adm, rhs_inc, with_bm, rb)
    return a, b, np.asarray(bc.types) == 0


def single_layer_self_terms(mesh: SurfaceMesh, k: float, dtype=None, device=None):
    """S_ii = (1/4pi) sum w (e^{ikR} - 1)/(ik): the weakly singular self
    integral of G, analytic radial part (used by Dirichlet problems)."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    self_r, self_w = _self_angular_rule(mesh)
    return _self_sums(torch.tensor(self_r, dtype=dtype, device=device),
                      torch.tensor(self_w, dtype=dtype, device=device), k)[0]
