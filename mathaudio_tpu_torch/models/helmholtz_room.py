"""Flagship FEM room model and its frequency-major sweep (counterpart of
mathaudio_tpu/models/helmholtz_room.py).

K/M/boundary mass assembled once and kept device-resident, a Gaussian
monopole source assembled into the RHS, and the nearest mesh node of each
listening position. Two solvers consume it: the node-major DIA sweep
(models/room_sweep_nm.py, structured box meshes) and ``sweep_pressure``,
the ELL sweep for any mesh.

``sweep_pressure`` is the reference's per-frequency vmap of single-vector
GMRES with a per-frequency multigrid, run as ONE batched solve over the
band: vectors are (N, F), each lane's operator is its own complex ELL
table (N, W, F) combined once from the frequency-shared K/M/B tables, the
multigrid levels carry per-lane tables (fem/multigrid.py), and
``gmres_batched`` with CGS2 follows the single-vector control flow lane
for lane. The matvecs are ELL gathers in plain torch; no DIA kernel runs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mathaudio_tpu_torch.fem.assembly import (
    HelmholtzAssembler,
    assemble_rhs,
    scatter_diag,
    scatter_ell,
)
from mathaudio_tpu_torch.fem.mesh import Mesh
from mathaudio_tpu_torch.fem.multigrid import (
    MgLevel,
    MgParams,
    _build_level,
    _gather_sum,
    _operator_tables,
    _safe_inverse,
    build_coarse_inv_chain,
    build_mg_params,
    mg_cycle,
)
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig
from mathaudio_tpu_torch.solvers.krylov_batched import gmres_batched
from mathaudio_tpu_torch.solvers.operators import EllOperator
from mathaudio_tpu_torch.xtypes import default_float, pressure_to_spl, resolve_device


class RoomParams(NamedTuple):
    """Device state of the room model (the 'weights')."""

    k_vals: torch.Tensor  # (nnz,) stiffness values
    m_vals: torch.Tensor  # (nnz,) mass values
    b_sum: torch.Tensor  # (nnz,) summed wall boundary-mass values
    rhs: torch.Tensor  # (N,) complex source vector
    ell_indices: torch.Tensor  # (N, W) int64
    csr2ell: torch.Tensor  # (nnz,) int64
    row_of_slot: torch.Tensor  # (nnz,) int32
    col_of_slot: torch.Tensor  # (nnz,) int32
    listen_idx: torch.Tensor  # (L,) int64


def system_values_of(params: RoomParams, k, absorption: float):
    """K - k^2 M - i k beta B as one elementwise combine, for one k."""
    cd = params.rhs.dtype
    coeff = torch.as_tensor(-1j * k * absorption, dtype=cd, device=params.rhs.device)
    return (params.k_vals - (k**2) * params.m_vals).to(cd) + coeff * params.b_sum.to(cd)


def operator_of(params: RoomParams, vals, num_nodes: int, ell_width: int) -> EllOperator:
    return EllOperator(
        params.ell_indices, scatter_ell(vals, params.csr2ell, num_nodes, ell_width), num_nodes
    )


def jacobi_of(params: RoomParams, vals, num_nodes: int):
    return _safe_inverse(scatter_diag(vals, params.row_of_slot, params.col_of_slot, num_nodes))


def sweep_pressure(
    params: RoomParams,
    ks,
    absorption: float,
    config: KrylovConfig,
    num_nodes: int,
    ell_width: int,
    mg_builder=None,
    mg_shift=(1.0, 0.5),
    mg_nu: int = 2,
    mg_omega: float = 2.0 / 3.0,
    mg_coarse_anchors: int = 0,
    mg_nu_post=None,
    mg_cycle_type: str = "v",
):
    """Batched sweep: (F,) wavenumbers -> pressure (F, L) complex,
    iterations (F,), converged (F,).

    With ``mg_builder`` (fem.multigrid.MgBuilder) GMRES is preconditioned
    by a shifted-Laplacian multigrid cycle built per frequency; otherwise
    by Jacobi. ``mg_coarse_anchors > 0`` shares the coarse dense inverse
    across chunks of adjacent frequencies (``ks`` sorted): that many
    Newton-Schulz-chained inverses at the chunks' mean wavenumbers
    (fem.multigrid.build_coarse_inv_chain), with the level-0 smoothing on
    the TRUE operator. When the chunks are equal and a multiple of 128
    lanes each chunk's lanes share their anchor's inverse in one batched
    product; otherwise each lane gets its anchor's inverse. Without
    anchors every lane has its own direct coarse inverse and a shifted
    level 0, as the reference builds them."""
    cd = params.rhs.dtype
    dev = params.rhs.device
    ks = torch.as_tensor(ks, dtype=params.k_vals.dtype, device=dev)
    n_f = ks.shape[0]

    # Per-lane complex values of the fine operator: one combine of the
    # frequency-shared tables, (N, W, F); its inverse diagonal (N, F).
    robin = (-1j * ks.to(cd)) * absorption  # per lane, as the reference's -1j k absorption
    ell_c, inv_diag = _operator_tables(params, ks, robin, (1.0, 0.0))

    def matvec(x):
        return _gather_sum(params.ell_indices, ell_c, x)

    if mg_builder is None:
        pre = lambda v: inv_diag * v  # noqa: E731
    else:
        if mg_coarse_anchors:
            n_anchor = min(int(mg_coarse_anchors), n_f)
            anchor_ids = (torch.arange(n_f, device=dev) * n_anchor) // n_f
            counts = torch.zeros(n_anchor, dtype=ks.dtype, device=dev).index_add_(
                0, anchor_ids, torch.ones_like(ks))
            anchor_ks = torch.zeros(n_anchor, dtype=ks.dtype, device=dev).index_add_(
                0, anchor_ids, ks) / counts
            anchor_inv = build_coarse_inv_chain(
                mg_builder, anchor_ks, (-1j * absorption) * anchor_ks.to(cd), shift=mg_shift)
            # level 0 smooths on the TRUE operator, reusing the fine tables
            bl0 = mg_builder.levels[0]
            levels = [MgLevel(params.ell_indices, ell_c, inv_diag, bl0.p_idx, bl0.p_w,
                              bl0.r_idx, bl0.r_w)]
            levels += [_build_level(bl, ks, robin, mg_shift) for bl in mg_builder.levels[1:-1]]
            chunk = n_f // n_anchor if n_f % n_anchor == 0 else 0
            coarse = anchor_inv if chunk and chunk % 128 == 0 else anchor_inv[anchor_ids]
            mgp = MgParams(tuple(levels), coarse)
        else:
            mgp = build_mg_params(mg_builder, ks, robin_coeff=robin, shift=mg_shift)

        def pre(r):
            return mg_cycle(mgp, r, omega=mg_omega, nu=mg_nu, cycle=mg_cycle_type,
                            nu_post=mg_nu_post)

    b = params.rhs[:, None].expand(num_nodes, n_f).contiguous()
    sol = gmres_batched(matvec, b, config=config, preconditioner=pre, orth="cgs2")
    return sol.x[params.listen_idx, :].T, sol.iterations, sol.converged


class RoomSweepModel:
    """Device-resident room model: absorbing walls (admittance Robin),
    Gaussian monopole source, listening-position output."""

    def __init__(
        self,
        mesh: Mesh,
        wall_tags: Sequence[int] = (1, 2, 3, 4, 5, 6),
        absorption: float = 0.1,
        source_position=(0.5, 0.5, 0.5),
        source_width: float = 0.1,
        listening_positions=((0.25, 0.25, 0.25),),
        dtype=None,
        assembler: Optional[HelmholtzAssembler] = None,
        device=None,
    ):
        """``assembler``: a prebuilt HelmholtzAssembler for ``mesh`` (e.g.
        GeometricMultigrid.assemblers[0]) to avoid assembling the fine
        level twice; its dtype and device then take precedence."""
        if assembler is not None:
            dtype, device = assembler.dtype, assembler.device
        else:
            dtype = dtype or default_float()
            device = resolve_device(device)
        self.dtype = dtype
        self.device = device
        self.mesh = mesh
        self.absorption = absorption
        self.assembler = assembler if assembler is not None else HelmholtzAssembler(
            mesh, robin_tags=tuple(wall_tags), dtype=dtype, device=device
        )
        self.wall_tags = tuple(wall_tags)
        self.num_nodes = mesh.num_nodes
        self.ell_width = self.assembler.ell_width

        # Gaussian source RHS (sigma = source_width), unit-monopole
        # normalization (int f dV = 1); frequency-independent.
        src = np.asarray(source_position, np.float64)[: mesh.dim]
        sw = 2.0 * source_width**2
        norm = (2.0 * np.pi * source_width**2) ** (mesh.dim / 2.0)

        def source_fn(x):
            r2 = torch.sum((x - torch.as_tensor(src, dtype=x.dtype, device=x.device)) ** 2, dim=-1)
            return torch.exp(-r2 / sw) / norm

        rhs = assemble_rhs(mesh, source_fn, dtype, device=device).to(self.assembler.cdtype)

        # Nearest-node listening positions (P1-exact at nodes).
        lp = np.asarray(listening_positions)[:, : mesh.dim]
        d2 = ((mesh.nodes[None, :, :] - lp[:, None, :]) ** 2).sum(-1)
        listen_idx = np.argmin(d2, axis=1)

        b_sum = sum(self.assembler.b_vals[t] for t in self.wall_tags)
        self._params = RoomParams(
            k_vals=self.assembler.k_vals,
            m_vals=self.assembler.m_vals,
            b_sum=b_sum,
            rhs=rhs,
            ell_indices=self.assembler.ell_indices,
            csr2ell=self.assembler.csr2ell,
            row_of_slot=self.assembler.row_of_slot,
            col_of_slot=self.assembler.col_of_slot,
            listen_idx=torch.as_tensor(listen_idx, device=device),
        )

    def params(self) -> RoomParams:
        return self._params

    def sweep_fn(self, config: Optional[KrylovConfig] = None, mg_builder=None,
                 mg_nu: int = 2, mg_omega: float = 2.0 / 3.0,
                 mg_coarse_anchors: int = 0, mg_nu_post=None,
                 mg_cycle_type: str = "v"):
        """(params, ks) -> (pressure, iterations, converged). Pass an
        fem.multigrid.MgBuilder for the shifted-Laplacian multigrid
        preconditioner (built per frequency); ``mg_coarse_anchors`` shares
        coarse inverses across frequency chunks (see sweep_pressure)."""
        if mg_cycle_type not in ("v", "w", "f"):
            raise ValueError(f"unknown multigrid cycle type {mg_cycle_type!r}")
        config = config or KrylovConfig(max_iterations=300, tolerance=1e-5, restart=30)
        return partial(
            sweep_pressure,
            absorption=self.absorption,
            config=config,
            num_nodes=self.num_nodes,
            ell_width=self.ell_width,
            mg_builder=mg_builder,
            mg_nu=mg_nu,
            mg_omega=mg_omega,
            mg_coarse_anchors=mg_coarse_anchors,
            mg_nu_post=mg_nu_post,
            mg_cycle_type=mg_cycle_type,
        )

    def sweep(self, ks, config: Optional[KrylovConfig] = None):
        fn = self.sweep_fn(config)
        return fn(self._params, torch.as_tensor(ks, dtype=self.dtype, device=self.device))

    def sweep_spl(self, ks, config: Optional[KrylovConfig] = None):
        p, its, conv = self.sweep(ks, config)
        return pressure_to_spl(torch.abs(p)), its, conv
