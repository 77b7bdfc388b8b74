"""Flagship FEM room model, device state only (counterpart of
mathaudio_tpu/models/helmholtz_room.py::RoomSweepModel, lines 222-283).

K/M/boundary mass assembled once and kept device-resident, a Gaussian
monopole source assembled into the RHS, and the nearest mesh node of each
listening position. The node-major sweep (models/room_sweep_nm.py) is the
solver that consumes it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mathaudio_tpu_torch.fem.assembly import HelmholtzAssembler, assemble_rhs
from mathaudio_tpu_torch.fem.mesh import Mesh
from mathaudio_tpu_torch.xtypes import default_float, resolve_device


class RoomParams(NamedTuple):
    """Device state of the room model (the 'weights')."""

    k_vals: torch.Tensor  # (nnz,) stiffness values
    m_vals: torch.Tensor  # (nnz,) mass values
    b_sum: torch.Tensor  # (nnz,) summed wall boundary-mass values
    rhs: torch.Tensor  # (N,) complex source vector
    row_of_slot: torch.Tensor  # (nnz,) int32
    col_of_slot: torch.Tensor  # (nnz,) int32
    listen_idx: torch.Tensor  # (L,) int64


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
            row_of_slot=self.assembler.row_of_slot,
            col_of_slot=self.assembler.col_of_slot,
            listen_idx=torch.as_tensor(listen_idx, device=device),
        )

    def params(self) -> RoomParams:
        return self._params
