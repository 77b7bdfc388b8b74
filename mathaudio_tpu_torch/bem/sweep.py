"""Batched BEM frequency sweep (counterpart of mathaudio_tpu/bem/sweep.py):
a band of wavenumbers assembled and solved as batched dense algebra, the
collocation assembly through the pairwise kernels of
ops/bem_assembly.py (hand-written CUDA on the GPU).

The reference's ``vmap`` over wavenumbers is a leading batch dimension:
matrices are (F, N, N), right-hand sides and pressures (F, N).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from mathaudio_tpu_torch.bem.assembly import _assemble, _auto_row_block, _mesh_tensors
from mathaudio_tpu_torch.bem.incident import IncidentField
from mathaudio_tpu_torch.bem.mesh import SurfaceMesh
from mathaudio_tpu_torch.solvers.direct import complex_solve
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig
from mathaudio_tpu_torch.solvers.krylov_batched import gmres_batched
from mathaudio_tpu_torch.utils.profiling import count, tally
from mathaudio_tpu_torch.xtypes import (
    complex_dtype_for,
    default_float,
    full_f32_matmul,
    resolve_device,
)


class SweepStatics(NamedTuple):
    """Frequency-independent mesh tensors on the sweep's device."""

    centers: torch.Tensor  # (N, 3)
    normals: torch.Tensor  # (N, 3)
    qp: torch.Tensor  # (N, nq, 3)
    qw: torch.Tensor  # (N, nq)
    self_r: torch.Tensor  # (N, n_ang)
    self_w: torch.Tensor  # (N, n_ang)


def sweep_statics(mesh: SurfaceMesh, quad_order: int = 3, dtype=None, device=None) -> SweepStatics:
    """The mesh's statics as ``dtype`` (default float32) tensors on
    ``device`` (default ``cuda``; raises without a GPU)."""
    return SweepStatics(*_mesh_tensors(mesh, quad_order, dtype or default_float(),
                                       resolve_device(device)))


def _solve_gmres(a, r, gmres_tol: float, gmres_restart: int):
    """Jacobi-preconditioned restarted GMRES on the (F, N, N) band.

    One lockstep ``gmres_batched`` (CGS2) over the F lanes stands for the
    reference's ``vmap`` of its single-vector ``gmres``: the JAX package's
    own tests show the two equal lane for lane (tests/test_nodemajor.py,
    ``TestBatchedGmres``), so the band is solved without F Python-level
    solves. Vectors are (N, F); the matvec is a batched complex matrix
    product, run in true float32 (no TF32)."""
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    inv_diag = torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, 1.0).T

    def matvec(v):
        return torch.matmul(a, v.T.unsqueeze(-1)).squeeze(-1).T

    cfg = KrylovConfig(max_iterations=4 * gmres_restart, tolerance=gmres_tol,
                       restart=gmres_restart)
    with full_f32_matmul():
        sol = gmres_batched(matvec, r.T, config=cfg,
                            preconditioner=lambda v: inv_diag * v, orth="cgs2")
    tally("bem.gmres.lane_iterations", sol.iterations)
    count("bem.gmres.lanes", int(r.shape[0]))
    return sol.x.T


def sweep_apply(statics: SweepStatics, ks, betas, rhs, burton_miller: bool = False,
                row_block: int = -1, freq_chunk: int = 0, solver: str = "lu",
                gmres_tol: float = 1e-5, gmres_restart: int = 16):
    """(F, N) surface pressures for wavenumbers ``ks`` (F,), couplings
    ``betas`` (F,) complex (zeros without Burton–Miller) and right-hand
    sides ``rhs`` (F, N) (already combined with -beta dp/dn).

    ``row_block``: -1 auto — one-shot assembly for N <= 2048, and at any N
    on the GPU when the batch's output planes fit (the kernel never
    materialises the (F, R, N, nq) buffers the chunking bounds; the
    reference's "Pallas active" rule); otherwise row chunks sized so
    those buffers stay near 256 MB.

    ``freq_chunk``: 0 solves the whole band at once; otherwise chunks of
    that many wavenumbers in turn, the band padded up to whole chunks by
    repeating its last wavenumber (padded rows are dropped).

    ``solver``: 'lu' (batched native LU) or 'gmres' (Jacobi-preconditioned
    GMRES, restart ``gmres_restart``, at most 4 restarts, on the
    assembled matrices)."""
    if solver not in ("lu", "gmres"):
        raise ValueError(f"unknown solver {solver!r}")
    n = statics.centers.shape[0]
    nf = int(ks.shape[0])
    if row_block < 0:
        f_eff = max(min(nf, freq_chunk or nf), 1)
        planes = 6 if burton_miller else 3
        if n <= 2048 or (
            statics.centers.device.type == "cuda"
            and f_eff * n * n * (4 * planes + 8) <= 10 * 1024**3
        ):
            row_block = 0
        else:
            row_block = _auto_row_block(n, statics.qp.shape[1] * f_eff)

    def band(k, beta, r):
        a = _assemble(statics.centers, statics.normals, statics.qp, statics.qw,
                      statics.self_r, statics.self_w, k, beta, burton_miller, row_block)
        if solver == "gmres":
            return _solve_gmres(a, r, gmres_tol, gmres_restart)
        return complex_solve(a, r)

    if freq_chunk and 0 < freq_chunk < nf:
        pad = (-nf) % freq_chunk
        if pad:
            ks = torch.cat([ks, ks[-1:].expand(pad)])
            betas = torch.cat([betas, betas[-1:].expand(pad)])
            rhs = torch.cat([rhs, rhs[-1:].expand(pad, -1)])
        out = [band(ks[c:c + freq_chunk], betas[c:c + freq_chunk], rhs[c:c + freq_chunk])
               for c in range(0, nf + pad, freq_chunk)]
        return torch.cat(out)[:nf]
    return band(ks, betas, rhs)


def sweep_fn(mesh: SurfaceMesh, quad_order: int = 3, burton_miller: bool = False,
             dtype=None, device=None):
    """Returns ``(ks, betas, rhs, **options) -> (F, N) pressures`` with the
    mesh statics built once on ``device``."""
    statics = sweep_statics(mesh, quad_order, dtype, device)
    return partial(sweep_apply, statics, burton_miller=burton_miller)


def sweep_inputs(mesh: SurfaceMesh, statics: SweepStatics, ks, incident: IncidentField,
                 burton_miller: bool = False, beta_scale: float = 4.0):
    """(betas (F,), rhs (F, N)) of ``bem_frequency_sweep`` for the band ks.

    Burton–Miller: beta = scale * i/(k + 1/h), h the mean element size. A
    positive ``beta_scale`` is the constant scale; 0/None selects the
    piecewise ka rule (4 below ka = 0.5, 2 to ka = 2, 1 above) per
    wavenumber. The right-hand side is p_inc - beta dp_inc/dn."""
    cd = complex_dtype_for(ks.dtype)
    p_inc = incident.pressure(statics.centers, ks)
    if not burton_miller:
        return torch.zeros_like(ks, dtype=cd), p_inc
    h = mesh.avg_element_size()
    ka = ks * mesh.ka_radius()
    if beta_scale and beta_scale > 0:
        scales = torch.full_like(ks, beta_scale)
    else:
        scales = torch.where(ka < 0.5, 4.0, torch.where(ka < 2.0, 2.0, 1.0)).to(ks.dtype)
    betas = scales * 1j / (ks + 1.0 / max(h, 1e-12))
    rhs = p_inc - betas[:, None] * incident.normal_derivative(statics.centers, statics.normals, ks)
    return betas, rhs


def bem_frequency_sweep(mesh: SurfaceMesh, ks, incident: IncidentField,
                        burton_miller: bool = False, beta_scale: float = 4.0,
                        quad_order: int = 3, dtype=None, device=None):
    """(F, N) surface pressures for a band of wavenumbers (direct LU,
    automatic row blocks), on ``device`` (default ``cuda``)."""
    dtype = dtype or default_float()
    statics = sweep_statics(mesh, quad_order, dtype, device)
    ks = torch.as_tensor(ks, dtype=dtype, device=statics.centers.device)
    betas, rhs = sweep_inputs(mesh, statics, ks, incident, burton_miller, beta_scale)
    return sweep_apply(statics, ks, betas, rhs, burton_miller=burton_miller)
