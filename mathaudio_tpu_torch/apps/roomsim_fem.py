"""FEM room simulator CLI (counterpart of mathaudio_tpu/apps/roomsim_fem.py).

Pipeline: RoomConfig JSON -> structured tet mesh of the room (a 3-level
nested hierarchy with multigrid) -> one-time K, M and per-wall boundary
mass assembly -> batched frequency sweep -> SPL at the listening positions
-> SimulationResults JSON.

Per-wall absorption or impedance gives each frequency its Robin
coefficients; sources are Gaussian monopoles (sigma 0.1 m by default) with
per-point directivity and per-frequency crossover weights. The reference
vmaps a single-vector GMRES preconditioned by a shifted-Laplacian V-cycle
(shift (1, 0.5), the walls' mean Robin coefficient) over each batch of
frequencies; here a batch is one solve over (N, F) lanes: per-lane complex
ELL tables (N, W, F) of K - k^2 M + sum_t alpha_t B_t, multigrid levels
and coarse inverses built per lane (``fem.multigrid.build_mg_params`` over
the band), and ``gmres_batched`` with CGS2 in its ``vmapped`` mode, which
follows the single-vector control flow lane for lane. Batches are sized by
``utils.memory.hbm_frequency_batch`` and the last one is padded by
repeating its last frequency, as the reference pads it. ``--hierarchical``
solves every ``anchor_stride``-th frequency cold in one batch and the rest
in a second batch, warm-started from linearly interpolated anchor
solutions.

The solves run on the GPU in float32 by default, on the CPU in float64
with ``--cpu``.

    python -m mathaudio_tpu_torch.apps.roomsim_fem configs/small_room.json [--cpu] [-o out.json]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from mathaudio_tpu_torch.common.config import WALL_TAGS, RoomConfig
from mathaudio_tpu_torch.common.output import create_output_json, generate_spatial_slices
from mathaudio_tpu_torch.fem.assembly import (
    HelmholtzAssembler,
    assemble_rhs,
    scatter_diag,
    scatter_ell,
)
from mathaudio_tpu_torch.fem.mesh import box_mesh_tetrahedra
from mathaudio_tpu_torch.fem.multigrid import (
    GeometricMultigrid,
    _gather_sum,
    _safe_inverse,
    box_hierarchy_dims,
    build_mg_params,
    vcycle,
)
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig
from mathaudio_tpu_torch.solvers.krylov_batched import gmres_batched
from mathaudio_tpu_torch.utils.memory import hbm_frequency_batch
from mathaudio_tpu_torch.utils.profiling import span
from mathaudio_tpu_torch.xtypes import SPEED_OF_SOUND, default_float, pressure_to_spl, resolve_device


def _mesh_dims(w, d, h, resolution, multiple=1):
    def rnd(x):
        n = max(1, round(x * resolution))
        return -(-n // multiple) * multiple

    return rnd(w), rnd(d), rnd(h)


class FemRoomSimulation:
    """Device-resident room simulation state (built once per config), on
    ``device`` (default the GPU) in ``dtype`` (default float32)."""

    def __init__(self, config: RoomConfig, use_multigrid: bool = True, verbose: int = 1,
                 source_width: float = 0.1, restart: Optional[int] = None,
                 batch_size: int = 0, memory_gb: float = 0.0, *, dtype=None, device=None):
        self.config = config
        self.source_width = source_width
        self.restart_override = restart
        self.batch_override = batch_size
        self.memory_gb = memory_gb
        self.sim = config.to_simulation()
        self.verbose = verbose
        dtype = dtype or default_float()
        self.device = device = resolve_device(device)
        w, d, h = self.sim.geometry.dimensions()
        res = config.solver.mesh_resolution

        levels = 3 if use_multigrid else 1
        nx, ny, nz = _mesh_dims(w, d, h, res, multiple=2 ** (levels - 1))
        tags = tuple(WALL_TAGS.values())
        with span("mesh+assembly", verbose):
            if use_multigrid:
                meshes, grid_dims = box_hierarchy_dims(
                    (nx, ny, nz), levels, bounds=(0, w, 0, d, 0, h)
                )
                self.mg = GeometricMultigrid(meshes, robin_tags=tags, dtype=dtype,
                                             grid_dims=grid_dims, device=device)
                self.mesh = meshes[0]
                self.assembler = self.mg.assemblers[0]
            else:
                self.mg = None
                self.mesh = box_mesh_tetrahedra(0, w, 0, d, 0, h, nx, ny, nz)
                self.assembler = HelmholtzAssembler(self.mesh, robin_tags=tags, dtype=dtype,
                                                    device=device)

        self.wall_specs = config.boundaries.wall_specs()
        self.wall_names = list(WALL_TAGS)
        asm = self.assembler
        n, width = asm.num_nodes, asm.ell_width
        # the frequency-shared real tables K, M, B_wall in the ELL layout
        # and on the diagonal; each frequency is one combine of them
        tables = [asm.k_vals, asm.m_vals] + [asm.b_vals[WALL_TAGS[w]] for w in self.wall_names]
        self._ell = torch.stack([scatter_ell(v, asm.csr2ell, n, width) for v in tables])
        self._diag = torch.stack([scatter_diag(v, asm.row_of_slot, asm.col_of_slot, n)
                                  for v in tables])

        with span("source assembly", verbose):
            rhs_list = [assemble_rhs(self.mesh, self._source_fn(s), dtype, device=device)
                        .to(asm.cdtype) for s in self.sim.sources]
            self.rhs_stack = torch.stack(rhs_list) if rhs_list else torch.zeros(
                (0, n), dtype=asm.cdtype, device=device)

        lp = np.asarray([p.to_array() for p in self.sim.listening_positions])
        d2 = ((self.mesh.nodes[None] - lp[:, None]) ** 2).sum(-1)
        self.listen_idx = torch.as_tensor(np.argmin(d2, axis=1), device=device)

    def _source_fn(self, source):
        """Gaussian envelope (unit monopole: int f dV = 1, so the near field
        matches G = e^{ikr} / (4 pi r)) times the directivity towards each
        point; the pattern is interpolated on the host."""
        pos = source.position.to_array()
        sigma = self.source_width
        sw = 2.0 * sigma**2
        norm = (2.0 * np.pi * sigma**2) ** 1.5
        pat = source.directivity

        def source_fn(x):
            d = x - torch.as_tensor(pos, dtype=x.dtype, device=x.device)
            r2 = torch.sum(d**2, dim=-1)
            env = torch.exp(-r2 / sw) / norm
            r = torch.sqrt(r2)
            rs = torch.clamp_min(r, 1e-10)
            theta = torch.arccos(torch.clamp(d[..., 2] / rs, -1.0, 1.0))
            phi = torch.arctan2(d[..., 1], d[..., 0])
            fac = pat.interpolate_array(theta.cpu().numpy(), phi.cpu().numpy())
            fac = torch.as_tensor(fac, dtype=x.dtype, device=x.device)
            return env * torch.where(r < 1e-10, 1.0, fac)

        return source_fn

    def _robin_coeffs(self, k):
        """(T, F) complex Robin coefficients of the wall tags (order of
        WALL_TAGS) at the wavenumbers ``k`` (F,)."""
        k = np.atleast_1d(np.asarray(k, np.float64))
        coeffs = [[complex(self.wall_specs[name].robin_alpha(float(kf))) for kf in k]
                  for name in self.wall_names]
        return torch.tensor(coeffs, dtype=self.assembler.cdtype, device=self.device)

    def _sweep_fn(self, kcfg: KrylovConfig):
        """sweep(ks (F,), src_weights (F, S), x0s (N, F) or None) ->
        (x (N, F), iterations (F,), converged (F,)): one batched solve."""
        asm = self.assembler
        cd = asm.cdtype
        mg_builder = self.mg.builder if self.mg is not None else None

        def combine(tabs, k2, coeffs):
            """tabs (2 + T, ...) real -> (..., F) complex:
            K - k^2 M + sum_t coeff_t B_t per lane."""
            vals = (tabs[0][..., None] - tabs[1][..., None] * k2).to(cd)
            return vals + torch.einsum("t...,tf->...f", tabs[2:].to(cd), coeffs)

        def sweep(ks, src_weights, x0s):
            ks_t = torch.as_tensor(np.asarray(ks), dtype=asm.dtype, device=self.device)
            coeffs = self._robin_coeffs(ks)  # (T, F)
            ell = combine(self._ell, ks_t**2, coeffs)  # (N, W, F)

            def matvec(x):
                return _gather_sum(asm.ell_indices, ell, x)

            w = torch.as_tensor(np.asarray(src_weights), device=self.device).to(cd)
            rhs = torch.einsum("sn,fs->nf", self.rhs_stack, w)
            if mg_builder is not None:
                mgp = build_mg_params(mg_builder, ks_t, robin_coeff=torch.mean(coeffs, dim=0),
                                      shift=(1.0, 0.5))

                def pre(r):
                    return vcycle(mgp, r)
            else:
                inv_diag = _safe_inverse(combine(self._diag, ks_t**2, coeffs))

                def pre(r):
                    return inv_diag * r
            sol = gmres_batched(matvec, rhs, config=kcfg, preconditioner=pre, orth="cgs2",
                                x0=x0s, vmapped=True)
            return sol.x, sol.iterations, sol.converged

        return sweep

    def _krylov(self) -> KrylovConfig:
        gm = self.config.solver.gmres
        return KrylovConfig(max_iterations=gm.max_iter * 10, tolerance=gm.tolerance,
                            restart=self.restart_override or gm.restart)

    def source_weights(self, freqs) -> np.ndarray:
        """(F, S) per-frequency source weights (crossover x amplitude)."""
        out = np.ones((len(freqs), max(len(self.sim.sources), 1)))
        for si, s in enumerate(self.sim.sources):
            for fi, f in enumerate(freqs):
                out[fi, si] = s.amplitude * s.crossover.amplitude_at_frequency(float(f))
        return out

    def run(self, hierarchical: bool = False, anchor_stride: int = 4):
        if hierarchical:
            return self._run_hierarchical(anchor_stride=anchor_stride)
        return self._run_flat()

    def _run_hierarchical(self, anchor_stride: int = 4):
        """Anchor frequencies solved cold in one batch, the others
        warm-started in a second batch from the linear interpolation (in k)
        of their neighbouring anchors' solutions."""
        cfg = self.config
        freqs = self.sim.frequencies
        sweep = self._sweep_fn(self._krylov())
        ks = 2.0 * np.pi * freqs / SPEED_OF_SOUND
        weights = self.source_weights(freqs)
        n = self.mesh.num_nodes
        nf = len(freqs)

        anchors = sorted(set(list(range(0, nf, anchor_stride)) + [nf - 1]))
        inter = [i for i in range(nf) if i not in anchors]
        xa, its_a, cv_a = sweep(ks[anchors], weights[anchors], None)
        x_full = torch.zeros((n, nf), dtype=xa.dtype, device=xa.device)
        x_full[:, anchors] = xa
        its = np.zeros(nf, int)
        conv = np.zeros(nf, bool)
        its[anchors] = its_a.cpu().numpy()
        conv[anchors] = cv_a.cpu().numpy()

        if inter:
            x0s = torch.zeros((n, len(inter)), dtype=xa.dtype, device=xa.device)
            for t, i in enumerate(inter):
                lo = max(a for a in anchors if a < i)
                hi = min(a for a in anchors if a > i)
                w_hi = (ks[i] - ks[lo]) / (ks[hi] - ks[lo])
                x0s[:, t] = (1 - w_hi) * x_full[:, lo] + w_hi * x_full[:, hi]
            xi, its_i, cv_i = sweep(ks[inter], weights[inter], x0s)
            x_full[:, inter] = xi
            its[inter] = its_i.cpu().numpy()
            conv[inter] = cv_i.cpu().numpy()
            if self.verbose:
                print(
                    f"hierarchical: anchors avg {its[anchors].mean():.1f} iters, "
                    f"warm-started avg {its[inter].mean():.1f} iters",
                    file=sys.stderr,
                )

        p = x_full[self.listen_idx, :].T.cpu().numpy()  # (F, L)
        spl = pressure_to_spl(np.abs(p)).numpy()
        results = create_output_json(
            cfg, freqs, spl,
            extra_metadata={
                "engine": "fem", "hierarchical": True,
                "num_nodes": int(n),
                "iterations": its.tolist(), "converged": conv.tolist(),
            },
        )
        for i, r in enumerate(results.results):
            r.converged = bool(conv[i])
            r.iterations = int(its[i])
            r.pressure_real = p[i].real.tolist()
            r.pressure_imag = p[i].imag.tolist()
        return results

    def _run_flat(self):
        cfg = self.config
        freqs = self.sim.frequencies
        kcfg = self._krylov()
        sweep = self._sweep_fn(kcfg)
        ks = 2.0 * np.pi * freqs / SPEED_OF_SOUND
        weights = self.source_weights(freqs)

        n = self.mesh.num_nodes
        if self.batch_override:
            batch = self.batch_override
        else:
            kwargs = {}
            if self.memory_gb:
                kwargs["budget_bytes"] = int(self.memory_gb * 2**30)
            batch = hbm_frequency_batch(
                num_dofs=n,
                nnz=self.assembler.csr.nnz,
                restart=kcfg.restart,
                levels=3 if self.mg is not None else 1,
                **kwargs,
            )
        if self.verbose:
            print(
                f"mesh: {self.mesh.num_elements} tets, {n} nodes; "
                f"{len(freqs)} frequencies in batches of {batch}",
                file=sys.stderr,
            )

        all_p = np.zeros((len(freqs), len(self.sim.listening_positions)), complex)
        iters = np.zeros(len(freqs), int)
        conv = np.zeros(len(freqs), bool)
        times = np.zeros(len(freqs))

        for start in range(0, len(freqs), batch):
            sl = slice(start, min(start + batch, len(freqs)))
            nb = sl.stop - sl.start
            pad = batch - nb
            kb = np.pad(ks[sl], (0, pad), mode="edge")
            wb = np.pad(weights[sl], ((0, pad), (0, 0)), mode="edge")
            t0 = time.perf_counter()
            x, its, cv = sweep(kb, wb, None)
            p = x[self.listen_idx, :].T.cpu().numpy()  # waits for the device
            its, cv = its.cpu().numpy(), cv.cpu().numpy()
            dt = (time.perf_counter() - t0) / nb
            all_p[sl] = p[:nb]
            iters[sl] = its[:nb]
            conv[sl] = cv[:nb]
            times[sl] = dt
            if self.verbose:
                print(
                    f"  f[{sl.start}:{sl.stop}] iters={its[:nb].tolist()} "
                    f"({dt*1e3:.0f} ms/freq)",
                    file=sys.stderr,
                )

        spl = pressure_to_spl(np.abs(all_p)).numpy()
        results = create_output_json(
            cfg,
            freqs,
            spl,
            extra_metadata={
                "engine": "fem",
                "num_nodes": int(n),
                "num_elements": int(self.mesh.num_elements),
                "converged": conv.tolist(),
                "iterations": iters.tolist(),
                "avg_solve_time_s": float(times.mean()),
            },
        )
        for i, r in enumerate(results.results):
            r.converged = bool(conv[i])
            r.iterations = int(iters[i])
            r.solve_time_s = float(times[i])
            r.pressure_real = all_p[i].real.tolist()
            r.pressure_imag = all_p[i].imag.tolist()
        self._maybe_add_slices(results, freqs, ks, weights)
        return results

    def _maybe_add_slices(self, results, freqs, ks, weights):
        """Spatial SPL slices at the listening height for the selected
        frequencies (the config's visualization section), from the nearest
        node's pressure."""
        viz = self.config.visualization
        if not viz.generate_slices:
            return
        idxs = viz.slice_frequency_indices or [len(freqs) // 2]
        z = float(np.mean([p.to_array()[2] for p in self.sim.listening_positions]) or 1.2)
        w, d, h = self.sim.geometry.dimensions()
        sweep = self._sweep_fn(self._krylov())
        for fi in idxs:
            if fi >= len(freqs):
                continue
            x, _, _ = sweep(ks[fi: fi + 1], weights[fi: fi + 1], None)
            u = x[:, 0].cpu().numpy()

            def pressure_at(pts, u=u):
                d2 = ((self.mesh.nodes[None] - pts[:, None]) ** 2).sum(-1)
                return u[np.argmin(d2, axis=1)]

            sl = generate_spatial_slices(pressure_at, (w, d, h), z,
                                         resolution=viz.slice_resolution)
            sl["frequency"] = float(freqs[fi])
            results.slices.append(sl)


def run_fem_simulation(config: RoomConfig, verbose: int = 1, use_multigrid: bool = True,
                       hierarchical: bool = False, anchor_stride: int = 4,
                       source_width: float = 0.1, restart: Optional[int] = None,
                       batch_size: int = 0, memory_gb: float = 0.0, *, dtype=None, device=None):
    return FemRoomSimulation(
        config, use_multigrid=use_multigrid, verbose=verbose,
        source_width=source_width, restart=restart,
        batch_size=batch_size, memory_gb=memory_gb, dtype=dtype, device=device,
    ).run(hierarchical=hierarchical, anchor_stride=anchor_stride)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="roomsim-fem", description="FEM Helmholtz room simulator (PyTorch/CUDA)"
    )
    ap.add_argument("config", help="RoomConfig JSON file")
    ap.add_argument("-o", "--output", default="room_fem_results.json")
    ap.add_argument("-v", "--verbose", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64 (default: the GPU in float32)")
    ap.add_argument("--no-multigrid", action="store_true")
    ap.add_argument("--hierarchical", action="store_true",
                    help="anchor + warm-start sweep")
    ap.add_argument("--mesh-resolution", type=int, default=None, help="elements per meter")
    ap.add_argument("--elements-per-wavelength", type=float, default=None,
                    help="set mesh resolution from the max frequency (6-10 typical)")
    ap.add_argument("--source-width", type=float, default=0.1,
                    help="Gaussian source sigma in meters")
    ap.add_argument("--restart", type=int, default=None, help="Krylov subspace size override")
    ap.add_argument("--batch-size", type=int, default=0,
                    help="frequency batch size (0 = automatic from the memory budget)")
    ap.add_argument("--memory-gb", type=float, default=0.0,
                    help="device memory budget in GB for automatic batch sizing")
    ap.add_argument("--anchor-stride", type=int, default=4,
                    help="hierarchical warm-start anchor stride")
    args = ap.parse_args(argv)
    where = dict(dtype=torch.float64, device="cpu") if args.cpu else {}

    config = RoomConfig.from_file(args.config)
    if args.mesh_resolution:
        config.solver.mesh_resolution = args.mesh_resolution
    if args.elements_per_wavelength:
        f_max = float(max(config.to_simulation().frequencies))
        res = int(np.ceil(args.elements_per_wavelength * f_max / SPEED_OF_SOUND))
        config.solver.mesh_resolution = max(res, 1)
        if args.verbose:
            print(
                f"adaptive mesh: {args.elements_per_wavelength} elem/wavelength "
                f"at {f_max:.0f} Hz -> {config.solver.mesh_resolution} elem/m",
                file=sys.stderr,
            )
    results = run_fem_simulation(
        config, verbose=args.verbose, use_multigrid=not args.no_multigrid,
        hierarchical=args.hierarchical, anchor_stride=args.anchor_stride,
        source_width=args.source_width, restart=args.restart,
        batch_size=args.batch_size, memory_gb=args.memory_gb, **where,
    )
    results.save(args.output)
    if args.verbose:
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
