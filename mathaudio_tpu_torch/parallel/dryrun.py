"""The port's multi-rank dry run: the five stages of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py``) on ``torch.distributed``, one
process per rank, in float64 at tiny shapes.

    python -m mathaudio_tpu_torch.parallel.dryrun 4          # NCCL, one card per rank
    python -m mathaudio_tpu_torch.parallel.dryrun 8 --cpu    # gloo on the CPU

1. the ELL room sweep (``RoomSweepModel``, unit cube n = 5) split over the
   'freq' axis of a (freq x dof) mesh (``shard_frequency_sweep``,
   ``shard_room_params``): the gathered pressures finite, of shape
   (2 n_freq, 2);
2. the explicit row-sharded solve (``build_sharded_system`` +
   ``sharded_gmres_fn``: halo ELL SpMV, all-reduced GMRES, per-rank
   Schwarz) of a tridiagonal Helmholtz system of 16 rows per rank over a
   'dof' axis of every rank: converged, true residual < 1e-5;
3. the headline node-major sweep split over a 'freq' axis of every rank
   (``sharded_sweep_fn``, warm starts), against the unsharded sweep chunked
   like one rank: max |difference| < 1e-10;
4. the cluster-sharded SLFMM solve (N = 320, k = 2) over an 'fmm' axis
   against the unsharded GMRES: relative difference < 1e-8;
5. the sharded MLFMM tree solve (N = 1280, k = 4) against the unsharded
   gather-form tree: relative difference < 1e-8.

Rank 0 runs the unsharded comparisons and prints the reference's line,
``dryrun_multichip OK: mesh=(FxD) devices=n ...``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _rank(rank: int, world: int, device_type: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from mathaudio_tpu_torch.bem.fmm import (
        ClusterBlockPreconditioner,
        build_mlfmm_tree_system,
        build_slfmm_system,
        gather_form,
    )
    from mathaudio_tpu_torch.bem.incident import plane_wave
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.fem.mesh import unit_cube_tetrahedra
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel, sweep_pressure
    from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
    from mathaudio_tpu_torch.parallel.fmm_spmd import (
        shard_mlfmm_tree,
        shard_slfmm,
        sharded_mlfmm_tree_solve_fn,
        sharded_slfmm_solve_fn,
    )
    from mathaudio_tpu_torch.parallel.mesh import (
        mesh_device,
        shard_frequency_sweep,
        shard_room_params,
        sweep_mesh,
    )
    from mathaudio_tpu_torch.parallel.spmd import build_sharded_system, sharded_gmres_fn, unshard
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres
    from mathaudio_tpu_torch.solvers.sparse import CsrMatrix

    f64 = torch.float64
    n_dof = 2 if world % 2 == 0 and world >= 4 else 1
    n_freq = world // n_dof
    out = {"mesh": f"({n_freq}x{n_dof})"}

    # 1. the ELL room sweep over (freq x dof)
    mesh_dev = sweep_mesh(world, dof_parallel=n_dof, device_type=device_type)
    dev = mesh_device(mesh_dev)
    model = RoomSweepModel(unit_cube_tetrahedra(5), wall_tags=(1, 2, 3, 4, 5, 6), absorption=0.1,
                           listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)), dtype=f64,
                           device=dev)
    config = KrylovConfig(max_iterations=12, tolerance=1e-3, restart=6)

    def step(params, ks):
        return sweep_pressure(params, ks, absorption=model.absorption, config=config,
                              num_nodes=model.num_nodes, ell_width=model.ell_width)[0]

    ks = torch.linspace(0.8, 2.5, n_freq * 2, dtype=f64)
    p1 = shard_frequency_sweep(mesh_dev, step)(shard_room_params(mesh_dev, model.params()), ks)
    assert tuple(p1.shape) == (n_freq * 2, 2), p1.shape
    assert bool(torch.isfinite(torch.abs(p1)).all())
    out["out_shape"] = tuple(p1.shape)

    # 2. the explicit row-sharded Schwarz-GMRES over one 'dof' axis
    n = 16 * world
    h = 1.0 / (n + 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([(2.0 / h**2 - 4.0 + 0.6j) * np.ones(n), (-1.0 / h**2) * np.ones(n - 1),
                           (-1.0 / h**2) * np.ones(n - 1)]).astype(np.complex128)
    csr = CsrMatrix.from_triplets(rows, cols, vals, (n, n))
    xs = np.linspace(0, 1, n)
    rhs = np.exp(-((xs - 0.4) ** 2) / 0.02).astype(np.complex128)
    mesh_1d = init_device_mesh(device_type, (world,), mesh_dim_names=("dof",))
    system = build_sharded_system(csr, rhs, world, schwarz_overlap=2, device=dev)
    sol = sharded_gmres_fn(mesh_1d, KrylovConfig(max_iterations=100, tolerance=1e-8,
                                                 restart=30))(system)
    assert bool(sol.converged), "sharded Schwarz-GMRES did not converge"
    rel = np.linalg.norm(csr.matvec(unshard(sol.x, n).cpu().numpy()) - rhs) / np.linalg.norm(rhs)
    assert rel < 1e-5, f"sharded solve true residual too large: rel={rel:.2e}"
    out["spmd_gmres_iters"] = int(sol.iterations)

    # 3. the headline node-major sweep over one 'freq' axis, warm started
    meshes = box_hierarchy(6, 2)
    mg = GeometricMultigrid(meshes, robin_tags=(1, 2, 3, 4, 5, 6), dtype=f64, device=dev)
    nm = NodeMajorRoomSweep(RoomSweepModel(
        meshes[0], wall_tags=(1, 2, 3, 4, 5, 6), absorption=0.15,
        listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)), assembler=mg.assemblers[0]),
        mg)
    nm_config = KrylovConfig(max_iterations=60, tolerance=1e-6, restart=6)
    nf3 = 4 * world
    ks3 = torch.linspace(0.6, 2.1, nf3, dtype=f64)
    mesh_f = init_device_mesh(device_type, (world,), mesh_dim_names=("freq",))
    knobs = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=2, warm_stride=2, warm_restart=4,
                 warm_interp="cubic")
    p3, _, conv3 = nm.sharded_sweep_fn(mesh_f, nm_config, **knobs)(nm.params(), ks3)
    assert bool(conv3.all()), "sharded node-major sweep did not converge"
    if rank == 0:  # unsharded, chunked like one rank (same anchor grouping)
        p3_ref = nm.sweep_fn(nm_config, freq_chunk=nf3 // world, **knobs)(nm.params(), ks3)[0]
        out["nodemajor_sharded_maxerr"] = float(torch.max(torch.abs(p3 - p3_ref)))
        assert out["nodemajor_sharded_maxerr"] < 1e-10, out

    # 4. the cluster-sharded SLFMM solve over one 'fmm' axis
    mesh_fmm = init_device_mesh(device_type, (world,), mesh_dim_names=("fmm",))
    inc = plane_wave((0.0, 0.0, 1.0))
    k4 = 2.0
    surf4 = icosphere(1.0, 2)
    op4 = build_slfmm_system(surf4, k4, beta=1j / k4, dtype=f64, device=dev)
    pre4 = ClusterBlockPreconditioner.from_operator(op4)
    c4 = torch.tensor(surf4.centers, dtype=f64, device=dev)
    n4 = torch.tensor(surf4.normals, dtype=f64, device=dev)
    rhs4 = inc.pressure(c4, k4) - (1j / k4) * inc.normal_derivative(c4, n4, k4)
    cfg4 = KrylovConfig(max_iterations=150, tolerance=1e-8, restart=40)
    sol4 = sharded_slfmm_solve_fn(mesh_fmm, cfg4)(shard_slfmm(op4.data, world), pre4, rhs4)
    assert bool(sol4.converged), "sharded FMM GMRES did not converge"
    out["fmm_sharded_iters"] = int(sol4.iterations)
    if rank == 0:
        ref4 = gmres(op4, rhs4, config=cfg4, preconditioner=pre4).x
        out["fmm_sharded_err"] = float(torch.linalg.norm(sol4.x - ref4) / torch.linalg.norm(ref4))
        assert out["fmm_sharded_err"] < 1e-8, out

    # 5. the sharded MLFMM tree solve
    k5 = 4.0
    surf5 = icosphere(1.0, 3)
    op5 = build_mlfmm_tree_system(surf5, k5, max_per_leaf=16, dtype=f64, device=dev)
    assert len(op5.data.levels) >= 2, "tree degenerated to one level"
    pre5 = ClusterBlockPreconditioner.from_operator(op5)
    rhs5 = inc.pressure(torch.tensor(surf5.centers, dtype=f64, device=dev), k5)
    cfg5 = KrylovConfig(max_iterations=200, tolerance=1e-8, restart=50)
    sol5 = sharded_mlfmm_tree_solve_fn(mesh_fmm, cfg5)(shard_mlfmm_tree(op5.data, world), pre5,
                                                       rhs5)
    assert bool(sol5.converged), "sharded MLFMM tree GMRES did not converge"
    out["mlfmm_tree_sharded_iters"] = int(sol5.iterations)
    if rank == 0:
        ref5 = gmres(gather_form(op5), rhs5, config=cfg5, preconditioner=pre5).x
        out["mlfmm_tree_sharded_err"] = float(torch.linalg.norm(sol5.x - ref5)
                                              / torch.linalg.norm(ref5))
        assert out["mlfmm_tree_sharded_err"] < 1e-8, out
    return out


def dryrun_multichip(n_devices: int, device_type=None) -> str:
    """Run the five stages over ``n_devices`` ranks (NCCL on the cards
    unless ``device_type`` is "cpu": gloo) and return rank 0's line."""
    from mathaudio_tpu_torch.parallel.launch import launch

    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' (gloo)")
    return line(n_devices, launch(_rank, n_devices, device_type,
                                  backend="nccl" if device_type == "cuda" else "gloo")[0])


def line(n_devices: int, r: dict) -> str:
    """The reference's ``dryrun_multichip OK`` line from rank 0's results."""
    return (f"dryrun_multichip OK: mesh={r['mesh']} devices={n_devices} "
            f"out_shape={r['out_shape']} spmd_gmres_iters={r['spmd_gmres_iters']} "
            f"nodemajor_sharded_maxerr={r['nodemajor_sharded_maxerr']:.1e} "
            f"fmm_sharded_iters={r['fmm_sharded_iters']} "
            f"fmm_sharded_err={r['fmm_sharded_err']:.1e} "
            f"mlfmm_tree_sharded_iters={r['mlfmm_tree_sharded_iters']} "
            f"mlfmm_tree_sharded_err={r['mlfmm_tree_sharded_err']:.1e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n_devices, "cpu" if args.cpu else None), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
