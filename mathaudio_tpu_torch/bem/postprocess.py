"""Kirchhoff–Helmholtz field evaluation (counterpart of
mathaudio_tpu/bem/postprocess.py): the field off the surface from the
surface pressure and its normal derivative, through the representation
formula, as a second pairwise kernel.

    p(x) = p_inc(x) + int_Gamma [p(y) dG/dn_y(x, y) - G(x, y) q(y)] dS(y)

with q = dp/dn; a rigid scatterer has q = 0, which drops the single layer.
"""

from __future__ import annotations

import dataclasses
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


def evaluate_field_fmm(*args, **kwargs):
    """The FMM-accelerated evaluation is part of the FMM slice (slice 5)."""
    raise ValueError("evaluate_field_fmm is not ported yet (slice 5, FMM); use evaluate_field")


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
