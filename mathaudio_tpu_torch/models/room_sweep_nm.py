"""Node-major frequency sweep of the FEM room model (counterpart of
mathaudio_tpu/models/room_sweep_nm.py: NodeMajorParams,
NodeMajorRoomSweep with sweep_fn, sharded_sweep_fn and sweep_fn_jacobi).

Every vector is (N, F) with the frequency band in the minor axis; level
operators are DIA stencils over frequency-shared real tables
(fem/dia.py, a hand-written kernel on the card); GMRES and the multigrid
cycle are explicitly batched over lanes (solvers/krylov_batched.py,
fem/multigrid_batched.py). Structured box meshes only; the frequency-major
ELL sweep (models/helmholtz_room.py::sweep_pressure) takes any mesh.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mathaudio_tpu_torch.fem.dia import (
    DiaTables,
    _inv_diag,
    dia_matvec,
    dia_pattern,
    dia_residual,
    dia_tables_of,
)
from mathaudio_tpu_torch.fem.multigrid import (
    GeometricMultigrid,
    MgBuilder,
    box_grid_dims,
    build_coarse_inv_chain,
    prolongation_1d,
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
    # Per-level (pz, py, px) separable 1D transfer factors, or () when the
    # hierarchy is not a lexicographic box grid (gather stencil only).
    tp: Tuple[tuple, ...] = ()


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
        self.grid_dims = self._grid_dims(mg, len(levels))
        self._params = NodeMajorParams(
            offsets=tuple(offsets),
            fine_tables=fine_tables,
            levels=tuple(levels),
            mg_builder=builder,
            rhs=params.rhs,
            listen_idx=params.listen_idx,
            tp=self._tp_factors(mg, levels, model.dtype),
        )

    @property
    def offsets(self) -> Tuple[Tuple[int, ...], ...]:
        return self._params.offsets

    @staticmethod
    def _grid_dims(mg, n_levels: int) -> Tuple[Tuple[int, int, int], ...]:
        """(nx, ny, nz) node counts of every mesh of the hierarchy (the
        n_levels smoothing meshes and the coarsest), for the streamed
        transfers; () if a mesh is not a lexicographic box grid or a level
        pair breaks the 2:1 nesting (f = 2 (c - 1) + 1 per axis)."""
        dims = []
        for l in range(n_levels + 1):
            d = box_grid_dims(mg.meshes[l])
            if d is None:
                return ()
            dims.append(d)
        for df, dc in zip(dims[:-1], dims[1:]):
            if any(f != 2 * (c - 1) + 1 for f, c in zip(df, dc)):
                return ()
        return tuple(dims)

    @staticmethod
    def _tp_factors(mg, levels, dtype) -> Tuple[tuple, ...]:
        """Separable 1D transfer factors per level, checked against the
        gather stencil on a random vector; () if a level is not a
        lexicographic 2:1-nested box grid (the cycle then keeps the gather
        stencil)."""
        dims = NodeMajorRoomSweep._grid_dims(mg, len(levels))
        if not dims:
            return ()
        tps = []
        for l, dc in enumerate(dims[1:]):
            mats = [prolongation_1d(c - 1) for c in (dc[2], dc[1], dc[0])]
            # the same operator as the stencil, exactly
            rng = np.random.default_rng(l)
            v = rng.standard_normal(dc[0] * dc[1] * dc[2])
            y4 = np.einsum("zyx,Xx->zyX", v.reshape(dc[2], dc[1], dc[0]), mats[2])
            y4 = np.einsum("zyx,Yy->zYx", y4, mats[1])
            y4 = np.einsum("zyx,Zz->Zyx", y4, mats[0])
            p_idx = levels[l].p_idx.cpu().numpy()
            p_w = levels[l].p_w.cpu().numpy()
            y_st = (p_w * v[p_idx]).sum(axis=1)
            if not np.allclose(y4.ravel(), y_st, atol=1e-12 * max(1.0, abs(v).max())):
                return ()
            dev = levels[l].p_w.device
            tps.append(tuple(torch.as_tensor(m, dtype=dtype, device=dev) for m in mats))
        return tuple(tps)

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

        ``mg_cycle_type``: "v", "w" or "f". ``mg_transfers``: "gather"
        (default; row gathers of the transfer stencils), "tp" (the
        separable 1D factors ``params.tp`` as three per-axis real products),
        "stream" (per-axis interleaves and decimations as slices and adds;
        needs a 2:1-nested lexicographic box hierarchy) or "stream16" (the
        stream form on bfloat16 re/im planes: ~4e-3 rounding inside the
        preconditioner, so iterations may differ, the accepted solutions
        still meet the tolerance). All four are the same operator."""
        config = config or KrylovConfig(max_iterations=300, tolerance=1e-5, restart=30)
        if mg_transfers not in ("gather", "tp", "stream", "stream16"):
            raise ValueError(f"unknown mg_transfers {mg_transfers!r}")
        if mg_transfers in ("stream", "stream16") and not self.grid_dims:
            raise ValueError(
                f"mg_transfers={mg_transfers!r} needs a lexicographic "
                "2:1-nested box hierarchy (box_grid_dims failed on a level)"
            )
        check_cycle(mg_cycle_type)
        if gmres_orth not in ("cgs1", "cgs2"):
            raise ValueError(f"unknown orthogonalization {gmres_orth!r}")
        if warm_stride > 1 and warm_interp not in ("linear", "cubic"):
            raise ValueError(f"unknown warm_interp {warm_interp!r}")
        absorption = self.absorption
        grid_dims = self.grid_dims if mg_transfers in ("stream", "stream16") else ()

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
            mgp = make_dia_mg(
                offsets, params.levels, ks, absorption, anchor_inv,
                shift=mg_shift,
                tp=params.tp if mg_transfers == "tp" else (),
                dims=grid_dims,
                transfer_bf16=(mg_transfers == "stream16"),
            )
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

    def sharded_sweep_fn(
        self,
        mesh,
        config: Optional[KrylovConfig] = None,
        axis: str = "freq",
        **knobs,
    ):
        """Frequency-lane sharding of the headline sweep over a
        ``torch.distributed`` DeviceMesh (the rayon frequency loop,
        room_simulator_fem.rs:1139-1160), one process and one card per rank.

        The node-major layout makes this a pure data split: each rank runs
        the complete ``sweep_fn`` (DIA kernel on its card) on its contiguous
        chunk of ``ks``, with its own copy of the tables; there is no
        collective inside the solve, and each rank's loops end on its own
        chunk's convergence. The outputs are all-gathered over the axis, so
        every rank returns the whole band's (pressure (F, L), iterations
        (F,), converged (F,)) in ``ks`` order.

        ``ks`` must split evenly over the mesh's ``axis`` (else ValueError)
        and be sorted ascending. ``mg_coarse_anchors`` (in ``knobs``) counts
        anchors per rank: each rank anchors its own chunk, so an unsharded
        run with the same per-chunk grouping (anchors = per-rank count x
        ranks, or ``freq_chunk`` = the rank's lanes) matches lane for lane."""
        from mathaudio_tpu_torch.parallel.mesh import run_split

        fn = self.sweep_fn(config, **knobs)

        def sharded(params: NodeMajorParams, ks):
            return run_split(mesh, axis, ks, lambda local: fn(params, local), "frequencies")

        return sharded

    def sweep_fn_jacobi(self, config: Optional[KrylovConfig] = None):
        """Jacobi-preconditioned variant (no multigrid): (params, ks) ->
        (pressure (F, L), iterations (F,), converged (F,)). GMRES with the
        reference's default CGS2."""
        config = config or KrylovConfig(max_iterations=300, tolerance=1e-5, restart=30)
        absorption = self.absorption

        def fn(params: NodeMajorParams, ks):
            ks = torch.as_tensor(ks, dtype=params.fine_tables.k.dtype,
                                 device=params.rhs.device)
            nf = ks.shape[0]
            cd = params.rhs.dtype
            n = params.rhs.shape[0]
            offs = params.offsets[0]
            tabs = params.fine_tables
            k = ks.to(cd)
            cm_fine = k * k
            cb_fine = torch.tensor(-1j * absorption, dtype=cd, device=k.device) * k
            inv_diag = _inv_diag(tabs, cm_fine, cb_fine)
            a_mv = lambda x: dia_matvec(offs, tabs, cm_fine, cb_fine, x)  # noqa: E731
            a_res = lambda b, x: dia_residual(offs, tabs, cm_fine, cb_fine, x, b)  # noqa: E731
            b = params.rhs[:, None].expand(n, nf).contiguous()
            sol = gmres_batched(a_mv, b, config=config, preconditioner=lambda v: inv_diag * v,
                                a_res=a_res)
            return sol.x[params.listen_idx, :].T, sol.iterations, sol.converged

        return fn
