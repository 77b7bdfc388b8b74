"""Interior room BEM (counterpart of mathaudio_tpu/bem/room_acoustics.py).

Interior Helmholtz with sources in the fluid and locally-reacting walls.
With fluid-side collocation, normals pointing out of the fluid (into the
walls), and wall admittance dp/dn = ik beta p (rigid: beta = 0):

    (1/2) p + D[p] - ik beta S[p] = p_src   on Gamma
    p(x) = p_src(x) + S[q](x) - D[p](x),  q = ik beta p,  x in the room

(single layer S with analytic-radial self terms, double layer D with the
static row-sum correction sum_j D0_ij = -1/2: the half-solid-angle
identity holds from either side).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from mathaudio_tpu_torch.bem.assembly import _mesh_tensors, _resolve_row_block, _self_sums
from mathaudio_tpu_torch.bem.mesh import SurfaceMesh
from mathaudio_tpu_torch.bem.postprocess import _chunked_points, _surface_tensors, field_row_block
from mathaudio_tpu_torch.common.source import Source
from mathaudio_tpu_torch.ops.bem_assembly import pairwise_mixed
from mathaudio_tpu_torch.solvers.direct import lu_solve
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres
from mathaudio_tpu_torch.solvers.preconditioners.basic import jacobi_preconditioner
from mathaudio_tpu_torch.xtypes import complex_dtype_for, default_float, resolve_device


def _room_matrix(centers, normals, qp, qw, self_r, self_w, k, beta, row_block=0):
    """A = (1/2)I + D + ik beta S for the interior problem, (N, N).

    The reference forms D_k, D_0 and S_k inline over (N, N, nq) tensors;
    these are exactly the planes of ``pairwise_mixed`` without
    Burton–Miller, so the quadrature sums go through it (the hand-written
    kernel on the GPU). The regularisation is that of the exterior
    assembly: the static plane's diagonal is zeroed through a view before
    the row sum, and A is built in D_k's buffer. ``row_block > 0``
    assembles row chunks in a loop."""
    n = centers.shape[0]
    cd = complex_dtype_for(centers.dtype)
    ks = torch.tensor([k], dtype=centers.dtype, device=centers.device)
    col = (1j * k) * beta.to(cd)  # (N,) column factor of S
    step = n if row_block <= 0 or row_block >= n else row_block
    out = None if step == n else torch.empty((n, n), dtype=cd, device=centers.device)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        dk, d0s, sk, _, _, _ = pairwise_mixed(centers[r0:r1], normals[r0:r1], qp, normals, qw,
                                              ks, False)

        def diagonal(t):
            return torch.diagonal(t[..., r0:r1], dim1=-2, dim2=-1)

        diagonal(d0s).zero_()
        d_diag = -0.5 - torch.sum(d0s, dim=1)  # half-solid-angle identity
        s_self, _ = _self_sums(self_r[r0:r1], self_w[r0:r1], k)
        a, s_mat = dk[0], sk[0]
        diagonal(a).copy_((0.5 + d_diag).to(cd))
        diagonal(s_mat).copy_(s_self)
        a.sub_(s_mat.mul_(col[None, :]))
        if out is None:
            return a
        out[r0:r1] = a
    return out


def _source_pressure(points, sources: Sequence[Source], k, frequency):
    """Sum of the sources' free-field monopole pressures at ``points``."""
    cd = complex_dtype_for(points.dtype)
    p = torch.zeros(points.shape[0], dtype=cd, device=points.device)
    for s in sources:
        src = torch.tensor(s.position.to_array(), dtype=points.dtype, device=points.device)
        amp = s.amplitude * s.crossover.amplitude_at_frequency(frequency)
        r = torch.linalg.vector_norm(points - src, dim=-1)
        rs = torch.where(r < 1e-12, 1.0, r)
        p = p + amp * torch.exp(1j * (k * rs).to(cd)) / (4.0 * math.pi * rs)
    return p


@dataclasses.dataclass
class RoomBemSolution:
    mesh: SurfaceMesh
    k: float
    frequency: float
    surface_pressure: torch.Tensor
    admittance: torch.Tensor
    sources: Sequence[Source]
    info: dict

    def evaluate_pressure(self, points, quad_order: int = 3):
        """Interior field via the representation formula
        p = p_src + S q - D p  (q = ik beta p on the walls), on the
        solution's device and in its precision, in chunks of field points
        (see postprocess.field_row_block)."""
        cd = self.surface_pressure.dtype
        dtype = self.surface_pressure.real.dtype
        device = self.surface_pressure.device
        points = torch.as_tensor(points, dtype=dtype, device=device).contiguous()
        qp, qw, normals = _surface_tensors(self.mesh, quad_order, dtype, device)
        p_src = _source_pressure(points, self.sources, self.k, self.frequency)
        q_surf = (1j * self.k) * self.admittance.to(cd) * self.surface_pressure
        row_block = field_row_block(self.mesh.num_elements, points.shape[0], points, True)
        kh = _chunked_points(points, qp, qw, normals, self.surface_pressure, q_surf,
                             self.k, row_block)
        return p_src - kh


def solve_room_bem(mesh: SurfaceMesh, frequency: float, sources: Sequence[Source],
                   admittance=0.0, method: str = "lu", quad_order: int = 3,
                   speed_of_sound: float = 343.0,
                   gmres_config: Optional[KrylovConfig] = None, dtype=None,
                   device=None) -> RoomBemSolution:
    """Solve one frequency of the interior room problem on ``device``
    (default ``cuda``; raises without a GPU). ``admittance`` is the
    normalized wall admittance beta (scalar or per-element); ``method``
    "lu" runs the dense LU and any other value, as in the reference,
    Jacobi-preconditioned GMRES (``gmres_config`` or 1000 iterations,
    tolerance 1e-8, restart 50)."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    k = 2.0 * math.pi * frequency / speed_of_sound
    n = mesh.num_elements
    beta = torch.tensor(np.broadcast_to(np.asarray(admittance, float), (n,)).copy(),
                        dtype=dtype, device=device)
    centers, normals, qp, qw, self_r, self_w = _mesh_tensors(mesh, quad_order, dtype, device)
    rb = _resolve_row_block(None, n, qp.shape[1], centers, "mixed")
    a = _room_matrix(centers, normals, qp, qw, self_r, self_w, k, beta, rb)
    rhs = _source_pressure(centers, sources, k, frequency)
    info = {"method": method, "n": n}
    if method == "lu":
        p = lu_solve(a, rhs)
        info["converged"] = True
    else:
        cfg = gmres_config or KrylovConfig(max_iterations=1000, tolerance=1e-8, restart=50)
        sol = gmres(a, rhs, config=cfg, preconditioner=jacobi_preconditioner(torch.diagonal(a)))
        p = sol.x
        info["converged"] = bool(sol.converged)
        info["iterations"] = int(sol.iterations)
    return RoomBemSolution(mesh, k, frequency, p, beta, sources, info)
