"""Perfectly matched layers via complex coordinate stretching (counterpart
of mathaudio_tpu/fem/pml.py): per-direction regions with polynomial
absorption profiles.

Stretched Helmholtz:  div(Lambda grad u) + k^2 (s_x s_y s_z) u = 0,
Lambda = diag(s_y s_z / s_x, s_x s_z / s_y, s_x s_y / s_z),
s_i(x) = 1 + i sigma_i(x)/k,  sigma_i a polynomial ramp inside the layer.

Assembled as complex K_pml and M_pml over the standard shared sparsity: one
batched element computation on the device (the (E, nq, d, d) Jacobians,
their determinants and inverses, the stretch at every quadrature point),
then one ``index_add_`` per value vector into the CSR slots.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from mathaudio_tpu_torch.fem.assembly import _find_slots, _tensor, coo_to_csr_map
from mathaudio_tpu_torch.fem.basis import element_tables
from mathaudio_tpu_torch.fem.mesh import Mesh
from mathaudio_tpu_torch.xtypes import complex_dtype_for, default_float, resolve_device


@dataclasses.dataclass
class PmlRegion:
    """One absorbing layer along an axis.

    axis: 0/1/2; side: +1 (layer at the max face) or -1 (min face);
    start: coordinate where the layer begins; thickness: layer depth;
    sigma_max: peak absorption; order: profile polynomial order
    (2 = quadratic).
    """

    axis: int
    side: int
    start: float
    thickness: float
    sigma_max: float = 20.0
    order: int = 2

    def sigma(self, coords):
        """sigma_i at coordinate tensors (..., dim), zero outside the layer."""
        x = coords[..., self.axis]
        depth = x - self.start if self.side > 0 else self.start - x
        t = torch.clamp(depth / self.thickness, 0.0, 1.0)
        return self.sigma_max * t**self.order


def pml_box_regions(bounds, thickness, sigma_max: float = 20.0, order: int = 2,
                    axes: Optional[Sequence[int]] = None) -> List[PmlRegion]:
    """Layers on all (or the selected) faces of a box domain, ``bounds`` =
    (x_min, x_max, y_min, y_max[, z_min, z_max])."""
    lo = np.asarray(bounds[0::2], float)
    hi = np.asarray(bounds[1::2], float)
    dim = len(lo)
    regions = []
    for ax in axes if axes is not None else range(dim):
        regions.append(PmlRegion(ax, -1, lo[ax] + thickness, thickness, sigma_max, order))
        regions.append(PmlRegion(ax, +1, hi[ax] - thickness, thickness, sigma_max, order))
    return regions


def assemble_pml_values(mesh: Mesh, regions: Sequence[PmlRegion], k: float, csr=None,
                        quad_order: int = 2, dtype=None, *, device=None):
    """(csr, k_vals, m_vals): the stretched stiffness and mass values, complex,
    on the shared sparsity (``csr``, or the mesh's own when None), on
    ``device`` (default the GPU). ``k`` enters through s = 1 + i sigma/k, so
    a sweep assembles this once per frequency."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    cdtype = complex_dtype_for(dtype)
    tab = element_tables(mesh.element_type, quad_order)
    nv, dim = tab.nv, tab.dim

    elems = mesh.elements
    rows = np.repeat(elems, nv, axis=1).reshape(-1)
    cols = np.tile(elems, (1, nv)).reshape(-1)
    if csr is None:
        csr, slot_map, _ = coo_to_csr_map(rows, cols, (mesh.num_nodes, mesh.num_nodes))
    else:
        slot_map = _find_slots(csr, rows, cols)

    coords = _tensor(mesh.nodes[mesh.elements], dtype, device)  # (E, nv, d)
    phi = _tensor(tab.phi, dtype, device)
    grad = _tensor(tab.grad, dtype, device)
    weights = _tensor(tab.weights, dtype, device)

    jac = torch.einsum("evd,qvk->eqdk", coords, grad)  # (E, nq, d, d)
    det = torch.abs(torch.linalg.det(jac))
    inv = torch.linalg.inv(jac)
    gphys = torch.einsum("qvk,eqkd->eqvd", grad, inv).to(cdtype)
    xq = torch.einsum("qv,evd->eqd", phi, coords)
    # the stretch s (E, nq, dim), one factor per region along its axis
    s = torch.ones(xq.shape[:-1] + (dim,), dtype=cdtype, device=device)
    for reg in regions:
        s[..., reg.axis] = s[..., reg.axis] * (1.0 + 1j * reg.sigma(xq) / k)
    s_prod = torch.prod(s, dim=-1)  # (E, nq)
    lam = s_prod[..., None] / (s * s)  # diag Lambda (E, nq, dim)
    wdet = (weights[None, :] * det).to(cdtype)
    k_e = torch.einsum("eq,eqd,eqvd,eqwd->evw", wdet, lam, gphys, gphys)
    phic = phi.to(cdtype)
    m_e = torch.einsum("eq,eq,qv,qw->evw", wdet, s_prod, phic, phic)

    slots = torch.as_tensor(slot_map, device=device)
    k_vals = torch.zeros(csr.nnz, dtype=cdtype, device=device).index_add_(0, slots, k_e.reshape(-1))
    m_vals = torch.zeros(csr.nnz, dtype=cdtype, device=device).index_add_(0, slots, m_e.reshape(-1))
    return csr, k_vals, m_vals
