"""Boundary conditions (counterpart of mathaudio_tpu/fem/boundary.py).

Semantics for  -div(grad u) - k^2 u = f:

- Dirichlet: u = g on tagged nodes; applied by fixed-sparsity row/column
  elimination (HelmholtzAssembler.apply_dirichlet_values).
- Neumann:   du/dn = g; adds int_Gamma g phi to the right-hand side.
- Robin:     du/dn + alpha u = g; adds +alpha B_tag to the system and
  int_Gamma g phi to the right-hand side.

The value and flux callables take coordinate tensors (..., d) and return
tensors of values; they run on the problem's device in its precision.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mathaudio_tpu_torch.fem.assembly import _face_table
from mathaudio_tpu_torch.fem.mesh import Mesh
from mathaudio_tpu_torch.xtypes import default_complex, real_dtype_for, resolve_device


@dataclasses.dataclass
class DirichletBC:
    tag: int
    value: Callable  # coords (..., d) -> complex value


@dataclasses.dataclass
class NeumannBC:
    tag: int
    flux: Callable  # coords (..., d) -> complex value


@dataclasses.dataclass
class RobinBC:
    tag: int
    alpha: complex
    g: Optional[Callable] = None

    @classmethod
    def absorbing(cls, tag: int, k: float) -> "RobinBC":
        """Sommerfeld radiation BC. With the e^{+ikr}/e^{-i omega t}
        convention an outgoing wave satisfies du/dn - ik u = 0, so
        alpha = -ik."""
        return cls(tag, -1j * k)

    @classmethod
    def absorbing_curved(cls, tag: int, k: float, radius: float, dim: int = 3) -> "RobinBC":
        """First-order Bayliss–Turkel radiation BC on a circle or sphere of
        the given radius: du/dn + (-ik + (dim-1)/(2 r)) u = 0."""
        return cls(tag, -1j * k + (dim - 1) / (2.0 * radius))

    @classmethod
    def admittance(cls, tag: int, k: float, beta: complex) -> "RobinBC":
        """Locally reacting wall of normalised admittance beta = rho c / Z:
        dp/dn = +ik beta p with n out of the fluid, i.e. alpha = -ik beta."""
        return cls(tag, -1j * k * beta)


def dirichlet_mask_and_values(mesh: Mesh, bcs: Sequence[DirichletBC], cdtype=None, *,
                              device=None):
    """(constrained (N,) bool, g (N,) complex with zeros on free nodes) on
    ``device`` (default ``cuda``); the values are taken at the nodes in the
    real precision of ``cdtype`` (default complex64)."""
    cdtype = cdtype or default_complex()
    device = resolve_device(device)
    n = mesh.num_nodes
    constrained = np.zeros(n, bool)
    g = np.zeros(n, np.complex128)
    for bc in bcs:
        nodes = mesh.boundary_nodes(tags=[bc.tag])
        constrained[nodes] = True
        vals = bc.value(torch.as_tensor(mesh.nodes[nodes], dtype=real_dtype_for(cdtype),
                                        device=device))
        g[nodes] = torch.as_tensor(vals).cpu().numpy().astype(np.complex128)
    return (torch.as_tensor(constrained, device=device),
            torch.as_tensor(g, dtype=cdtype, device=device))


def surface_load(mesh: Mesh, tag: int, fn: Callable, cdtype=None, *, device=None):
    """Right-hand side term int_Gamma_tag fn(x) phi_i dS over the boundary
    faces tagged ``tag`` (segments of a triangle mesh, triangles of a tet
    mesh): (N,) of ``cdtype`` (default complex64) on ``device``."""
    cdtype = cdtype or default_complex()
    rdtype = real_dtype_for(cdtype)
    device = resolve_device(device)
    faces = mesh.boundary_faces[mesh.boundary_markers == tag]
    n = mesh.num_nodes
    if len(faces) == 0:
        return torch.zeros(n, dtype=cdtype, device=device)
    _pts, w, phi, grad = _face_table(mesh.element_type)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=rdtype, device=device)

    coords, phi_d, grad_d, w_d = tensor(mesh.nodes[faces]), tensor(phi), tensor(grad), tensor(w)
    x_q = torch.einsum("qv,fvd->fqd", phi_d, coords)
    g_q = torch.as_tensor(fn(x_q)).to(cdtype)  # (F, nq)
    jac = torch.einsum("fvd,qvk->fqdk", coords, grad_d)
    metric = torch.einsum("fqdk,fqdl->fqkl", jac, jac)
    det = torch.sqrt(torch.abs(torch.linalg.det(metric)))
    contrib = torch.einsum("q,fq,fq,qv->fv", w_d.to(cdtype), det.to(cdtype), g_q,
                           phi_d.to(cdtype))
    idx = torch.as_tensor(faces.reshape(-1), dtype=torch.int64, device=device)
    return torch.zeros(n, dtype=cdtype, device=device).index_add_(0, idx, contrib.reshape(-1))
