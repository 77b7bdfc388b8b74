"""Kirchhoff–Helmholtz field evaluation (counterpart of
mathaudio_tpu/bem/postprocess.py): the field off the surface from the
surface pressure and its normal derivative, through the representation
formula, as a second pairwise kernel.

    p(x) = p_inc(x) + int_Gamma [p(y) dG/dn_y(x, y) - G(x, y) q(y)] dS(y)

with q = dp/dn; a rigid scatterer has q = 0, which drops the single layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mathaudio_tpu_torch.bem.assembly import _resolve_row_block
from mathaudio_tpu_torch.bem.incident import IncidentField
from mathaudio_tpu_torch.bem.mesh import SurfaceMesh
from mathaudio_tpu_torch.ops.bem_assembly import pairwise_kh
from mathaudio_tpu_torch.xtypes import (
    complex_dtype_for,
    default_float,
    full_f32_matmul,
    pressure_to_spl,
    resolve_device,
)


@dataclasses.dataclass
class FieldResult:
    """Pressures at the field points."""

    points: torch.Tensor
    p_inc: torch.Tensor
    p_scat: torch.Tensor

    @property
    def p_total(self):
        return self.p_inc + self.p_scat

    @property
    def spl_db(self):
        return pressure_to_spl(torch.abs(self.p_total))


def _kh_rows(points, qp, qw, normals, p_surf, q_surf, k):
    """Kirchhoff–Helmholtz contribution for a block of field points:
    int [p dG/dn_y - G q] dS. The quadrature sums come from ``pairwise_kh``
    (the hand-written kernel on the GPU), which skips the single-layer
    planes when ``q_surf`` is None."""
    ks = torch.tensor([k], dtype=points.dtype, device=points.device)
    s_mat, d_mat = pairwise_kh(points, qp, normals, qw, ks, want_single=q_surf is not None)
    with full_f32_matmul():
        out = d_mat[0] @ p_surf  # (M,)
        if q_surf is not None:
            out = out - s_mat[0] @ q_surf
    return out


def _chunked_points(points, qp, qw, normals, p_surf, q_surf, k, row_block):
    """Evaluate in chunks of ``row_block`` field points, so only
    (row_block, N) planes exist at once; the last chunk is ragged (the
    reference pads it with far-away points)."""
    m = points.shape[0]
    if row_block <= 0 or row_block >= m:
        return _kh_rows(points, qp, qw, normals, p_surf, q_surf, k)
    out = torch.empty((m,), dtype=p_surf.dtype, device=points.device)
    for r0 in range(0, m, row_block):
        r1 = min(m, r0 + row_block)
        out[r0:r1] = _kh_rows(points[r0:r1].contiguous(), qp, qw, normals, p_surf, q_surf, k)
    return out


def _surface_tensors(mesh: SurfaceMesh, quad_order: int, dtype, device):
    """(qp, qw, normals) of ``mesh`` on ``device``."""
    qp, qw = mesh.quad_points(quad_order)
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in (qp, qw, mesh.normals))


def field_row_block(num_elements: int, num_points: int, like: torch.Tensor,
                    want_single: bool) -> int:
    """Field points per chunk when the caller names none: the sizing of
    the assembly (``assembly._resolve_row_block``). On the GPU the chunk
    is what the kernel's (R, N) planes allow, four with the single layer
    and two without, so 8192 points against 5120 elements are one launch.
    On the CPU it is the reference's sizing with its kernel active:
    neither the kernel nor its q-looped twin holds an (R, N, nq) buffer,
    so the budget counts about three complex (R, N) planes whatever the
    quadrature order."""
    return _resolve_row_block(None, num_elements, 3, like, "kh" if want_single else "kh_double",
                              rows=num_points)


def evaluate_field(mesh: SurfaceMesh, p_surf, points, k: float,
                   incident: Optional[IncidentField] = None, quad_order: int = 3, dtype=None,
                   q_surf=None, row_block=None, device=None) -> FieldResult:
    """Total/scattered pressure at points off the surface, on ``device``
    (default ``cuda``; raises without a GPU). ``q_surf`` (dp/dn at element
    centers) adds the single-layer term for radiating / non-rigid
    surfaces; ``incident=None`` means pure radiation (p_inc = 0).
    ``row_block`` chunks the field points (None sizes it, see
    ``field_row_block``)."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    cd = complex_dtype_for(dtype)
    points = torch.as_tensor(points, dtype=dtype, device=device).contiguous()
    if row_block is None:
        row_block = field_row_block(mesh.num_elements, points.shape[0], points,
                                    q_surf is not None)
    qp, qw, normals = _surface_tensors(mesh, quad_order, dtype, device)
    p_surf = torch.as_tensor(p_surf, device=device).to(cd)
    if q_surf is not None:
        q_surf = torch.as_tensor(q_surf, device=device).to(cd)
    p_scat = _chunked_points(points, qp, qw, normals, p_surf, q_surf, k, int(row_block))
    p_inc = incident.pressure(points, k) if incident is not None else torch.zeros_like(p_scat)
    return FieldResult(points=points, p_inc=p_inc, p_scat=p_scat)


def evaluate_field_fmm(mesh: SurfaceMesh, p_surf, points, k: float,
                       incident: Optional[IncidentField] = None, quad_order: int = 3,
                       max_per_leaf: int = 32, separation_ratio: float = 2.0, dtype=None,
                       q_surf=None, *, device=None) -> FieldResult:
    """FMM-accelerated Kirchhoff–Helmholtz evaluation, on ``device``
    (default ``cuda``; raises without a GPU) in ``dtype`` (default
    float32): octrees over the surface elements and over the field points;
    far cluster pairs go through the diagonal-form expansion (aggregation
    shared with bem/fmm.py), near pairs use the exact kernel. Unstable
    low-frequency pairs demote to exact evaluation (the amplitude cap
    ``fmm._MLFMM_STABILITY_TAU``).

    ``q_surf`` (dp/dn at element centers) adds the single-layer -G q term
    for radiating / mixed-BC surfaces: the far field aggregates a second
    density through the factor-1 (single-layer) aggregation tensor and
    rides the same diagonal translations; near pairs reuse the exact G
    already computed for dG/dn. ``incident=None`` = pure radiation."""
    from mathaudio_tpu_torch.bem.fmm import (
        _MLFMM_STABILITY_TAU,
        _agg_disagg_tensors,
        _pack_clusters,
        translation_operator_pairwise,
        unit_sphere_quadrature,
    )
    from mathaudio_tpu_torch.bem.octree import Octree
    from mathaudio_tpu_torch.wave.special.spherical import spherical_jn_yn_all

    dtype = dtype or default_float()
    device = resolve_device(device)
    cd = complex_dtype_for(dtype)
    points = np.asarray(points, float)
    m_pts = len(points)
    # padded leaf clusters of the sources (surface elements) and targets (field points)
    s_cl, s_mk, s_cc, s_rr = _pack_clusters(
        Octree.build(mesh.centers, max_per_leaf=max_per_leaf).leaves, mesh.centers)
    t_cl, t_mk, t_cc, t_rr = _pack_clusters(
        Octree.build(points, max_per_leaf=max_per_leaf).leaves, points)

    kr = k * max(s_rr.max(), t_rr.max())
    order = int(np.ceil(kr + 4 * np.log(kr + np.pi) + 4))
    dirs, w = unit_sphere_quadrature(order)

    dist = np.linalg.norm(t_cc[:, None] - s_cc[None, :], axis=-1)
    far = dist > separation_ratio * (t_rr[:, None] + s_rr[None, :])
    fb, fa = np.where(far)
    # stability cap (low-frequency h_l blowup -> exact evaluation)
    if len(fb):
        krp = k * (t_rr[fb] + s_rr[fa])
        l_acc = np.ceil(krp + 4 * np.log(krp + np.pi) + 4).astype(int)
        kd = torch.as_tensor(k * dist[fb, fa], dtype=dtype, device=device)
        j_all, y_all = spherical_jn_yn_all(int(l_acc.max()), kd)
        h_abs = torch.hypot(j_all, y_all).cpu().numpy()
        l = np.arange(h_abs.shape[0])
        amp = np.where(l[:, None] <= l_acc[None, :], (2 * l + 1)[:, None] * h_abs, 0.0)
        stable = amp.max(axis=0) <= _MLFMM_STABILITY_TAU
        far[fb[~stable], fa[~stable]] = False
        fb, fa = fb[stable], fa[stable]
        l_pair = np.minimum(l_acc[stable], order)

    def t(a, dt=dtype):
        a = a if isinstance(a, torch.Tensor) else np.asarray(a)
        return torch.as_tensor(a, device=device).to(dt)

    def ids(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    with full_f32_matmul():
        t_tensor, _ = _agg_disagg_tensors(mesh, s_cl, s_mk, s_cc, k, dirs, dtype=dtype,
                                          device=device)
        t_single = None
        if q_surf is not None:
            t_single, _ = _agg_disagg_tensors(mesh, s_cl, s_mk, s_cc, k, dirs, single_layer=True,
                                              dtype=dtype, device=device)
        x_rel = t(points[t_cl] - t_cc[:, None, :])
        s_field = (torch.exp(1j * k * torch.einsum("qd,cmd->cqm", t(dirs), x_rel).to(cd))
                   * t(t_mk)[:, None, :])
        t_op = (translation_operator_pairwise(k, t_cc[fb] - s_cc[fa], dirs, order, l_pair,
                                              dtype=dtype, device=device) if len(fb) else None)

        # far: aggregate, translate (pair-packed), disaggregate. The
        # translation is diagonal/linear, so the single-layer density -q
        # merges into mu before translating: one D/S pass serves both
        # Kirchhoff-Helmholtz terms.
        s_cl_t, s_mk_t, t_mk_t = ids(s_cl), t(s_mk), t(t_mk)
        p = t(p_surf, cd)
        q = None if q_surf is None else t(q_surf, cd)
        mu = torch.einsum("cqm,cm->cq", t_tensor.to(cd), p[s_cl_t] * s_mk_t)
        if q is not None:
            mu = mu - torch.einsum("cqm,cm->cq", t_single.to(cd), q[s_cl_t] * s_mk_t)
        lam = torch.zeros((len(t_cl), len(dirs)), dtype=cd, device=device)
        if t_op is not None:
            lam.index_add_(0, ids(fb), t_op.to(cd) * mu[ids(fa)])
        pref = 1j * k / (16.0 * np.pi**2)  # +D: no CBIE minus
        p_far = pref * torch.einsum("q,cqm,cq->cm", t(w).to(cd), s_field, lam)

        # near: exact kernel blocks per (target cluster, source cluster)
        nb, na = np.where(~far)
        out = torch.zeros(m_pts, dtype=cd, device=device)
        out.index_add_(0, ids(t_cl).reshape(-1), (p_far * t_mk_t).reshape(-1))
        if len(nb):
            qp, qw = mesh.quad_points(quad_order)
            nb_t, na_t = ids(nb), ids(na)
            x = t(points[t_cl])[nb_t][:, :, None, None, :]
            src = s_cl_t[na_t]
            y = t(qp)[src][:, None, :, :, :]
            ny = t(mesh.normals)[src][:, None, :, None, :]
            rv = y - x
            r = torch.sqrt(torch.sum(rv * rv, dim=-1))
            rs = torch.where(r < 1e-15, 1.0, r)
            g = torch.exp(1j * (k * rs).to(cd)) / (4.0 * math.pi * rs)
            dg = (1j * k - 1.0 / rs) * g * torch.sum(rv * ny, dim=-1) / rs
            wq = t(qw)[src][:, None, :, :].to(cd)
            mask_ts = (t_mk_t[nb_t][:, :, None] * s_mk_t[na_t][:, None, :]).to(cd)
            blocks = torch.sum(dg * wq, dim=-1) * mask_ts  # (P, mt, ms)
            near_vals = torch.einsum("pij,pj->pi", blocks, p[src] * s_mk_t[na_t])
            if q is not None:
                s_blocks = torch.sum(g * wq, dim=-1) * mask_ts
                near_vals = near_vals - torch.einsum("pij,pj->pi", s_blocks, q[src] * s_mk_t[na_t])
            out.index_add_(0, ids(t_cl)[nb_t].reshape(-1),
                           (near_vals * t_mk_t[nb_t]).reshape(-1))
    pts = t(points)
    p_inc = incident.pressure(pts, k) if incident is not None else torch.zeros_like(out)
    return FieldResult(points=pts, p_inc=p_inc, p_scat=out)


def generate_sphere_eval_points(radius: float, n_theta: int, n_phi: int) -> np.ndarray:
    """(n_theta*n_phi, 3) points on a sphere around the origin, cell-center
    polar spacing."""
    theta = np.pi * (np.arange(n_theta) + 0.5) / n_theta
    phi = 2.0 * np.pi * np.arange(n_phi) / n_phi
    st, ct = np.sin(theta), np.cos(theta)
    x = radius * st[:, None] * np.cos(phi)[None, :]
    y = radius * st[:, None] * np.sin(phi)[None, :]
    z = radius * np.broadcast_to(ct[:, None], (n_theta, n_phi))
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)


def generate_line_eval_points(start, end, n_points: int) -> np.ndarray:
    """(n_points, 3) points from start to end inclusive."""
    t = np.arange(n_points) / max(n_points - 1, 1)
    start = np.asarray(start, float)
    end = np.asarray(end, float)
    return start[None, :] + t[:, None] * (end - start)[None, :]


def generate_plane_eval_points(center, normal, extent: float, n_points: int) -> np.ndarray:
    """(n_points^2, 3) grid on the plane through ``center`` with the given
    ``normal``, spanning +-extent along two in-plane basis vectors."""
    n = np.asarray(normal, float)
    n = n / np.linalg.norm(n)
    arbitrary = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, arbitrary)
    u = u / np.linalg.norm(u)
    v = np.cross(n, u)
    s = -extent + 2.0 * extent * np.arange(n_points) / max(n_points - 1, 1)
    center = np.asarray(center, float)
    grid = (center[None, None, :] + s[:, None, None] * u[None, None, :]
            + s[None, :, None] * v[None, None, :])
    return grid.reshape(-1, 3)
