"""Node-major frequency sweep of the FEM room model (counterpart of
mathaudio_tpu/models/room_sweep_nm.py: NodeMajorParams,
NodeMajorRoomSweep.__init__/_check_structured and sweep_fn).

Every vector is (N, F) with the frequency band in the minor axis; level
operators are DIA stencils over frequency-shared real tables
(fem/dia.py, a hand-written kernel on the card); GMRES and the V-cycle
are explicitly batched over lanes (solvers/krylov_batched.py,
fem/multigrid_batched.py). Structured box meshes only.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from mathaudio_tpu_torch.fem.dia import (
    DiaTables,
    dia_matvec,
    dia_pattern,
    dia_residual,
    dia_tables_of,
)
from mathaudio_tpu_torch.fem.multigrid import (
    GeometricMultigrid,
    MgBuilder,
    build_coarse_inv_chain,
)
from mathaudio_tpu_torch.fem.multigrid_batched import (
    DiaLevel,
    check_cycle,
    make_dia_mg,
    mg_cycle_batched,
)
from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig
from mathaudio_tpu_torch.solvers.krylov_batched import gmres_batched


class NodeMajorParams(NamedTuple):
    """Device state of the node-major sweep."""

    offsets: Tuple[Tuple[int, ...], ...]  # static DIA offsets per smoothing level
    fine_tables: DiaTables  # level-0 TRUE operator (also smoothing level 0)
    levels: Tuple[DiaLevel, ...]  # smoothing levels (level 0 shares fine_tables)
    mg_builder: MgBuilder  # coarsest-level pieces for the anchor inverses
    rhs: torch.Tensor  # (N,) complex
    listen_idx: torch.Tensor  # (L,)


class NodeMajorRoomSweep:
    """Host-side builder: extracts the DIA tables and static offsets of
    every level once, then emits a batched sweep function."""

    def __init__(self, model: RoomSweepModel, mg: GeometricMultigrid):
        if model.device != mg.device:
            raise ValueError(f"model is on {model.device}, multigrid on {mg.device}")
        self.model = model
        self.mg = mg
        self.absorption = model.absorption
        self.device = model.device

        def b_sum_of(asm):
            return sum(asm.b_vals.values()) if asm.b_vals else torch.zeros_like(asm.k_vals)

        self._check_structured(model.assembler)
        offs0, fine_tables = dia_tables_of(
            model.assembler, sum(model.assembler.b_vals[t] for t in model.wall_tags)
        )
        offsets = [offs0]
        levels = []
        builder = mg.builder
        for l, asm in enumerate(mg.assemblers[:-1]):
            bl = builder.levels[l]
            if l == 0:
                tabs = fine_tables
            else:
                self._check_structured(asm)
                offs_l, tabs = dia_tables_of(asm, b_sum_of(asm))
                offsets.append(offs_l)
            levels.append(DiaLevel(tabs, bl.p_idx, bl.p_w, bl.r_idx, bl.r_w))
        params = model.params()
        self._params = NodeMajorParams(
            offsets=tuple(offsets),
            fine_tables=fine_tables,
            levels=tuple(levels),
            mg_builder=builder,
            rhs=params.rhs,
            listen_idx=params.listen_idx,
        )

    @property
    def offsets(self) -> Tuple[Tuple[int, ...], ...]:
        return self._params.offsets

    @staticmethod
    def _check_structured(asm):
        """DIA storage is (n_diagonals, N); on an unstructured mesh the
        distinct col-row offsets approach O(N) and the tables blow up
        toward dense N^2. Require near-stencil density (box meshes have
        exactly 15 diagonals)."""
        offsets, _ = dia_pattern(asm.row_of_slot, asm.col_of_slot)
        nnz = int(asm.row_of_slot.shape[0])
        if len(offsets) * asm.num_nodes > 4 * nnz:
            raise ValueError(
                f"mesh is not structured enough for the node-major DIA sweep: "
                f"{len(offsets)} distinct diagonals x {asm.num_nodes} nodes vs "
                f"{nnz} nonzeros"
            )

    def params(self) -> NodeMajorParams:
        return self._params

    def sweep_fn(
        self,
        config: Optional[KrylovConfig] = None,
        mg_shift: Tuple[float, float] = (1.0, 0.5),
        mg_nu: int = 2,
        mg_omega: float = 2.0 / 3.0,
        mg_coarse_anchors: int = 0,
        mg_nu_post=None,
        mg_cycle_type: str = "v",
        gmres_orth: str = "cgs2",
        mg_transfers: str = "gather",
        freq_chunk: int = 0,
        warm_stride: int = 0,
        warm_restart: int = 0,
        warm_interp: str = "linear",
    ):
        """(params, ks) -> (pressure (F, L), iterations (F,), converged (F,)).

        ``ks`` must be sorted ascending (anchored coarse inverses assume
        contiguous chunks). ``mg_coarse_anchors <= 0`` means one coarse
        inverse per frequency; a positive count that does not divide the
        band is rounded down to the nearest divisor with a warning.

        ``freq_chunk`` > 0 streams the band through sequential chunks of
        that many frequencies (must divide len(ks)); anchors then count
        per chunk. ``warm_stride`` > 1 solves ks[::warm_stride] cold,
        interpolates those solutions across the band in lane index
        (``warm_interp`` "linear" or "cubic" Catmull-Rom, edges clamped)
        and solves the full band warm-started with restart
        ``warm_restart`` (0 = config.restart); anchor lanes report
        phase-1 + phase-2 iterations.

        ``mg_cycle_type`` and ``mg_transfers`` take the reference's values:
        the V-cycle ("v") with gather transfers ("gather") runs; W and F
        cycles and the "tp", "stream" and "stream16" transfers raise a
        ValueError naming slice 6 of the port, which brings them."""
        config = config or KrylovConfig(max_iterations=300, tolerance=1e-5, restart=30)
        if mg_transfers not in ("gather", "tp", "stream", "stream16"):
            raise ValueError(f"unknown mg_transfers {mg_transfers!r}")
        if mg_transfers != "gather":
            raise ValueError(
                f"mg_transfers={mg_transfers!r} is not ported yet: the tensor-product and "
                "streamed transfers come with slice 6 of the port; \"gather\" runs"
            )
        check_cycle(mg_cycle_type)
        if gmres_orth not in ("cgs1", "cgs2"):
            raise ValueError(f"unknown orthogonalization {gmres_orth!r}")
        if warm_stride > 1 and warm_interp not in ("linear", "cubic"):
            raise ValueError(f"unknown warm_interp {warm_interp!r}")
        absorption = self.absorption

        def fn(params: NodeMajorParams, ks):
            ks = torch.as_tensor(ks, dtype=params.fine_tables.k.dtype,
                                 device=params.rhs.device)
            nf_total = ks.shape[0]
            if freq_chunk and 0 < freq_chunk < nf_total:
                if nf_total % freq_chunk:
                    raise ValueError(
                        f"freq_chunk={freq_chunk} does not divide the band "
                        f"({nf_total} frequencies)"
                    )
                outs = [_one_chunk(params, ks_c) for ks_c in ks.split(freq_chunk)]
                p, its, conv = (torch.cat(parts) for parts in zip(*outs))
                return p, its, conv
            return _one_chunk(params, ks)

        def _band_solve(params: NodeMajorParams, ks, x0, cfg):
            """Cold or warm GMRES-MG solve of one (sub)band; returns the
            full KrylovSolution (x kept (N, F) for interpolation)."""
            nf = ks.shape[0]
            cd = params.rhs.dtype
            n = params.rhs.shape[0]
            offsets = params.offsets
            k = ks.to(cd)
            cm_fine = k * k
            cb_fine = torch.tensor(-1j * absorption, dtype=cd, device=k.device) * k

            na = nf if mg_coarse_anchors <= 0 else min(int(mg_coarse_anchors), nf)
            if nf % na:
                na = max(d for d in range(1, na + 1) if nf % d == 0)
                warnings.warn(
                    f"mg_coarse_anchors={mg_coarse_anchors} does not divide "
                    f"the band ({nf} frequencies); using {na} anchors",
                    stacklevel=3,
                )
            anchor_ks = torch.mean(ks.reshape(na, nf // na), dim=1)
            anchor_inv = build_coarse_inv_chain(
                params.mg_builder,
                anchor_ks,
                torch.tensor(-1j * absorption, dtype=cd, device=k.device) * anchor_ks.to(cd),
                shift=mg_shift,
            )
            mgp = make_dia_mg(offsets, params.levels, ks, absorption, anchor_inv, shift=mg_shift)
            tabs = params.fine_tables
            a_mv = lambda x: dia_matvec(offsets[0], tabs, cm_fine, cb_fine, x)  # noqa: E731
            a_res = lambda b, x: dia_residual(offsets[0], tabs, cm_fine, cb_fine, x, b)  # noqa: E731
            pre = lambda r: mg_cycle_batched(  # noqa: E731
                mgp, offsets, r, omega=mg_omega, nu=mg_nu, cycle=mg_cycle_type,
                nu_post=mg_nu_post,
            )
            b = params.rhs[:, None].expand(n, nf).contiguous()
            return gmres_batched(a_mv, b, config=cfg, preconditioner=pre,
                                 orth=gmres_orth, x0=x0, a_res=a_res)

        def _one_chunk(params: NodeMajorParams, ks):
            nf = ks.shape[0]
            if warm_stride > 1:
                s = int(warm_stride)
                if nf % s:
                    raise ValueError(f"warm_stride={s} does not divide the band ({nf})")
                sol_a = _band_solve(params, ks[::s].contiguous(), None, config)
                xa = sol_a.x  # (N, F/s) anchor solutions
                n = xa.shape[0]
                t = (torch.arange(s, dtype=torch.float64, device=xa.device) / s).to(xa.real.dtype)
                xp1 = torch.cat([xa[:, 1:], xa[:, -1:]], dim=1)
                if warm_interp == "cubic":
                    # Catmull-Rom on the uniform anchor grid; edge segments
                    # clamp the missing outer anchors
                    xm1 = torch.cat([xa[:, :1], xa[:, :-1]], dim=1)
                    xp2 = torch.cat([xp1[:, 1:], xp1[:, -1:]], dim=1)
                    t2, t3 = t * t, t * t * t
                    w0 = -0.5 * t3 + t2 - 0.5 * t
                    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
                    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
                    w3 = 0.5 * t3 - 0.5 * t2
                    x0 = (xm1[:, :, None] * w0 + xa[:, :, None] * w1
                          + xp1[:, :, None] * w2 + xp2[:, :, None] * w3)
                else:
                    # lane-linear; the last partial segment clamps to the
                    # final anchor
                    x0 = xa[:, :, None] * (1.0 - t) + xp1[:, :, None] * t
                x0 = x0.reshape(n, nf)  # (N, F/s, s) -> (N, F)
                cfg2 = config if warm_restart <= 0 else config._replace(
                    restart=int(warm_restart)
                )
                sol = _band_solve(params, ks, x0, cfg2)
                its = sol.iterations.clone()
                its[::s] += sol_a.iterations
            else:
                sol = _band_solve(params, ks, None, config)
                its = sol.iterations
            p = sol.x[params.listen_idx, :].T  # (F, L)
            return p, its, sol.converged

        return fn
