"""Batched P1 FEM assembly (counterpart of mathaudio_tpu/fem/assembly.py).

The JAX package vmaps a per-element kernel and scatter-adds into a fixed
CSR sparsity. Here the element kernel is one batched ``einsum`` over all
elements and the COO->CSR reduction is one ``index_add_`` per value
vector. The host builds the sparsity and the slot maps with numpy; the
value vectors live on the caller's device in the caller's dtype. The
per-frequency system K - k^2 M + sum(coeff_tag B_tag) is one elementwise
combine over the shared sparsity, scattered into a padded ELL table
(``scatter_ell``) for the gather matvec of the frequency-major sweep.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mathaudio_tpu_torch.fem.basis import element_tables, shape_functions
from mathaudio_tpu_torch.fem.mesh import TET, TRIANGLE, Mesh
from mathaudio_tpu_torch.fem.quadrature import segment_rule, triangle_rule
from mathaudio_tpu_torch.solvers.operators import EllOperator
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix
from mathaudio_tpu_torch.xtypes import complex_dtype_for, default_float, resolve_device


def scatter_ell(vals, csr2ell, n_rows: int, width: int):
    """CSR-ordered nnz values -> zero-padded ELL value table (n_rows, width).

    One definition for the sweep's fine operator, the multigrid level build
    and ``operator_of``, so their padding cannot drift apart."""
    out = torch.zeros(n_rows * width, dtype=vals.dtype, device=vals.device)
    out[csr2ell] = vals
    return out.reshape(n_rows, width)


def scatter_diag(vals, row_of_slot, col_of_slot, n_rows: int):
    """CSR-ordered nnz values -> the matrix diagonal (n_rows,)."""
    diag_vals = torch.where(row_of_slot == col_of_slot, vals, torch.zeros((), dtype=vals.dtype,
                                                                          device=vals.device))
    out = torch.zeros(n_rows, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, row_of_slot.long(), diag_vals)


def coo_to_csr_map(rows, cols, shape):
    """CSR structure + COO-entry -> CSR-slot map (duplicates share slots).

    Returns (csr, slot_map (nnz_coo,) int64, row_of_slot (nnz,) int32)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    order = np.lexsort((cols, rows))
    r_s, c_s = rows[order], cols[order]
    new_group = np.ones(len(r_s), bool)
    new_group[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
    group = np.cumsum(new_group) - 1
    slot_map = np.empty(len(rows), np.int64)
    slot_map[order] = group
    nnz = group[-1] + 1 if len(group) else 0
    out_rows = r_s[new_group]
    out_cols = c_s[new_group]
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.add.at(indptr, out_rows + 1, 1)
    indptr = np.cumsum(indptr)
    csr = CsrMatrix(indptr, out_cols.astype(np.int32), np.zeros(nnz), shape)
    return csr, slot_map, out_rows.astype(np.int32)


def element_kernel(coords, phi, grad, weights):
    """Stiffness/mass of every element at once.

    coords (E, nv, d); phi (nq, nv); grad (nq, nv, d); weights (nq,).
    Returns (K_e (E, nv, nv), M_e (E, nv, nv))."""
    jac = torch.einsum("evd,qvk->eqdk", coords, grad)  # dx/dxi
    det = torch.abs(torch.linalg.det(jac))  # (E, nq)
    inv = torch.linalg.inv(jac)  # dxi/dx
    gphys = torch.einsum("qvk,eqkd->eqvd", grad, inv)
    wdet = weights[None, :] * det
    k_e = torch.einsum("eq,eqvd,eqwd->evw", wdet, gphys, gphys)
    m_e = torch.einsum("eq,qv,qw->evw", wdet, phi, phi)
    return k_e, m_e


def _tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def assemble_stiffness_mass(mesh: Mesh, dtype=None, quad_order: int = 2, *, device=None):
    """K and M value vectors over a shared CSR sparsity, in ``dtype``
    (default float32) on ``device`` (default the GPU: ``resolve_device``).

    Returns (csr_structure, k_vals, m_vals, slot metadata dict)."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    tab = element_tables(mesh.element_type, quad_order)
    nv = tab.nv
    elems = mesh.elements
    rows = np.repeat(elems, nv, axis=1).reshape(-1)  # i index
    cols = np.tile(elems, (1, nv)).reshape(-1)  # j index
    n = mesh.num_nodes
    csr, slot_map, row_of_slot = coo_to_csr_map(rows, cols, (n, n))

    k_e, m_e = element_kernel(
        _tensor(mesh.nodes[mesh.elements], dtype, device),
        _tensor(tab.phi, dtype, device),
        _tensor(tab.grad, dtype, device),
        _tensor(tab.weights, dtype, device),
    )
    slots = torch.as_tensor(slot_map, device=device)
    k_vals = torch.zeros(csr.nnz, dtype=dtype, device=device).index_add_(0, slots, k_e.reshape(-1))
    m_vals = torch.zeros(csr.nnz, dtype=dtype, device=device).index_add_(0, slots, m_e.reshape(-1))
    meta = {"slot_map": slot_map, "row_of_slot": row_of_slot}
    return csr, k_vals, m_vals, meta


def assemble_lumped_mass(mesh: Mesh, dtype=None, quad_order: int = 2, *, device=None):
    """Row-sum lumped mass diagonal: (N,) with sum_j M_ij per node (its
    total is the mesh measure), in ``dtype`` on ``device``."""
    _csr, _k_vals, m_vals, meta = assemble_stiffness_mass(mesh, dtype, quad_order, device=device)
    rows = torch.as_tensor(meta["row_of_slot"], dtype=torch.int64, device=m_vals.device)
    return torch.zeros(mesh.num_nodes, dtype=m_vals.dtype, device=m_vals.device).index_add_(
        0, rows, m_vals)


def _lagrange_1d(nodes: np.ndarray, x: np.ndarray):
    """phi (nq, nv) and dphi (nq, nv) of the 1D Lagrange basis on `nodes`."""
    nv = len(nodes)
    phi = np.ones((len(x), nv))
    dphi = np.zeros((len(x), nv))
    for i in range(nv):
        for j in range(nv):
            if j == i:
                continue
            phi[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
        for m in range(nv):
            if m == i:
                continue
            term = np.ones(len(x)) / (nodes[i] - nodes[m])
            for j in range(nv):
                if j in (i, m):
                    continue
                term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            dphi[:, i] += term
    return phi, dphi


def _face_table(volume_type: str, order: int = 2):
    """(points, weights, phi, grad) on the boundary faces of a P1 volume:
    triangles for tets, segments for triangles."""
    if volume_type == TRIANGLE:
        nodes = np.array([0.0, 1.0])
        x, w = segment_rule(len(nodes))
        phi, dphi = _lagrange_1d(nodes, x)
        return x[:, None], w, phi, dphi[:, :, None]
    if volume_type == TET:
        pts, w = triangle_rule(order)
        phi, grad = shape_functions(TRIANGLE, pts)
        return pts, w, phi, grad
    raise ValueError(volume_type)


def _face_mass_kernel(coords, phi, grad, weights):
    """Boundary-face mass matrices (E_f, fv, fv), metric sqrt(det(J^T J))."""
    jac = torch.einsum("fvd,qvk->fqdk", coords, grad)  # (E_f, nq, d, d-1)
    metric = torch.einsum("fqdk,fqdl->fqkl", jac, jac)
    det = torch.sqrt(torch.abs(torch.linalg.det(metric)))
    wdet = weights[None, :] * det
    return torch.einsum("fq,qv,qw->fvw", wdet, phi, phi)


def _find_slots(csr: CsrMatrix, rows, cols):
    """CSR slot of each (row, col); entries must exist in the sparsity."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    n_cols = csr.shape[1]
    nnz_rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr))
    keys = nnz_rows * n_cols + csr.indices.astype(np.int64)
    want = rows * n_cols + cols
    slots = np.searchsorted(keys, want)
    if not np.all(keys[np.minimum(slots, len(keys) - 1)] == want):
        raise ValueError("boundary entries are not in the volume sparsity")
    return slots


def assemble_boundary_mass(mesh: Mesh, tag: int, csr: CsrMatrix, slot_map_unused=None,
                           dtype=None, *, device=None):
    """B_tag on the volume sparsity: B_ij = int_{Gamma_tag} phi_i phi_j dS,
    as a (nnz,) value vector aligned with ``csr``. ``slot_map_unused`` is
    the reference's unused slot, kept for its positional order."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    sel = mesh.boundary_markers == tag
    faces = mesh.boundary_faces[sel]
    if len(faces) == 0:
        return torch.zeros(csr.nnz, dtype=dtype, device=device)
    pts, w, phi, grad = _face_table(mesh.element_type)
    fv = faces.shape[1]
    rows = np.repeat(faces, fv, axis=1).reshape(-1)
    cols = np.tile(faces, (1, fv)).reshape(-1)
    slots = torch.as_tensor(_find_slots(csr, rows, cols), device=device)
    b_e = _face_mass_kernel(
        _tensor(mesh.nodes[faces], dtype, device),
        _tensor(phi, dtype, device),
        _tensor(grad, dtype, device),
        _tensor(w, dtype, device),
    )
    return torch.zeros(csr.nnz, dtype=dtype, device=device).index_add_(0, slots, b_e.reshape(-1))


def assemble_rhs(mesh: Mesh, source_fn: Callable, dtype=None, quad_order: int = 2, *,
                 device=None):
    """RHS vector b_i = int f phi_i dx via the same batched quadrature.

    ``source_fn`` maps coordinate tensors (..., d) -> scalar tensors."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    tab = element_tables(mesh.element_type, quad_order)
    coords = _tensor(mesh.nodes[mesh.elements], dtype, device)
    phi = _tensor(tab.phi, dtype, device)
    grad = _tensor(tab.grad, dtype, device)
    w = _tensor(tab.weights, dtype, device)
    x_q = torch.einsum("qv,evd->eqd", phi, coords)  # (E, nq, d)
    f_q = source_fn(x_q)  # (E, nq)
    jac = torch.einsum("evd,qvk->eqdk", coords, grad)
    det = torch.abs(torch.linalg.det(jac))
    contrib = torch.einsum("q,eq,eq,qv->ev", w.to(f_q.dtype), det.to(f_q.dtype), f_q,
                           phi.to(f_q.dtype))
    idx = torch.as_tensor(mesh.elements.reshape(-1), device=device)
    return torch.zeros(mesh.num_nodes, dtype=contrib.dtype, device=device).index_add_(
        0, idx, contrib.reshape(-1)
    )


class HelmholtzAssembler:
    """K, M and per-tag boundary masses assembled ONCE over a shared
    sparsity, device-resident. Carries the fields the DIA tables are
    built from (fem/dia.py dia_tables_of) and the ELL layout of the
    sparsity (width rounded up to a multiple of 8); ``assemble(k,
    robin_coeffs)`` gives the system K - k^2 M + sum(coeff_tag B_tag) as
    an ELL operator."""

    def __init__(self, mesh: Mesh, robin_tags: Sequence[int] = (), dtype=None, device=None):
        dtype = dtype or default_float()
        device = resolve_device(device)
        self.mesh = mesh
        self.dtype = dtype
        self.cdtype = complex_dtype_for(dtype)
        self.device = device
        csr, k_vals, m_vals, meta = assemble_stiffness_mass(mesh, dtype, device=device)
        self.csr = csr
        self.k_vals = k_vals
        self.m_vals = m_vals
        self.row_of_slot = torch.as_tensor(meta["row_of_slot"], device=device)
        self.col_of_slot = torch.as_tensor(csr.indices.astype(np.int32), device=device)
        self.robin_tags = tuple(robin_tags)
        self.b_vals = {
            tag: assemble_boundary_mass(mesh, tag, csr, dtype=dtype, device=device)
            for tag in self.robin_tags
        }
        ell_idx, csr2ell = csr.ell_structure(pad_to_multiple=8)
        self.ell_indices = torch.as_tensor(ell_idx, dtype=torch.int64, device=device)
        self.ell_width = ell_idx.shape[1]
        self.csr2ell = torch.as_tensor(csr2ell, device=device)
        self.num_nodes = mesh.num_nodes

    def system_values(self, k, robin_coeffs: Optional[Dict[int, complex]] = None):
        """(nnz,) complex values of K - k^2 M + sum coeff_tag B_tag."""
        vals = (self.k_vals - (k**2) * self.m_vals).to(self.cdtype)
        if robin_coeffs:
            for tag, coeff in robin_coeffs.items():
                vals = vals + torch.as_tensor(coeff, dtype=self.cdtype, device=self.device) * \
                    self.b_vals[tag].to(self.cdtype)
        return vals

    def apply_dirichlet_values(self, vals, constrained):
        """Zero constrained rows and columns, unit diagonal, on the fixed
        sparsity. ``constrained`` is an (N,) bool tensor."""
        row_c = constrained[self.row_of_slot.long()]
        col_c = constrained[self.col_of_slot.long()]
        keep = (~row_c) & (~col_c)
        diag_c = row_c & (self.row_of_slot == self.col_of_slot)
        return torch.where(keep, vals, torch.zeros((), dtype=vals.dtype, device=vals.device)) + \
            diag_c.to(vals.dtype)

    def dirichlet_rhs(self, vals, rhs, constrained, g):
        """b <- b - A g on free rows; b <- g on constrained rows. ``g`` is
        (N,) with the boundary values (zero on free nodes)."""
        ag = self.operator_from_values(vals).matvec(g.to(vals.dtype))
        return torch.where(constrained, g.to(rhs.dtype), rhs - ag.to(rhs.dtype))

    def operator_from_values(self, vals) -> EllOperator:
        return EllOperator(self.ell_indices,
                           scatter_ell(vals, self.csr2ell, self.num_nodes, self.ell_width),
                           self.num_nodes)

    def assemble(self, k, robin_coeffs=None, dirichlet_constrained=None):
        """One-call system operator for wavenumber k: (operator, values)."""
        vals = self.system_values(k, robin_coeffs)
        if dirichlet_constrained is not None:
            vals = self.apply_dirichlet_values(vals, dirichlet_constrained)
        return self.operator_from_values(vals), vals

    def diagonal_of(self, vals):
        """System diagonal for Jacobi preconditioning, from values."""
        return scatter_diag(vals, self.row_of_slot, self.col_of_slot, self.num_nodes)

