"""Rank functions of the port's multi-rank parity tests, and a one-rank
process group for the tests that run a sharded value in their own process.

The tests spawn gloo ranks through ``mathaudio_tpu_torch.parallel.launch``
(``launch_beside`` runs them while the test computes its reference); each
child imports this module anew, so it imports torch, numpy and the
port only (never JAX, nor a test file's fixtures). Inputs arrive as numpy
arrays; each function returns this rank's results as tensors, which the
launcher brings back to the parent on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

F64 = torch.float64
KRYLOV_NAMES = ("cg", "bicgstab", "cgs", "qmrcgstab", "gmres", "gmres_pipelined_ghysels",
                "gmres_pipelined", "gmres_with_guess")


@contextlib.contextmanager
def one_rank_group():
    """A gloo world of one rank in this process, with a one-axis ("dof")
    CPU DeviceMesh; the process group is destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'pg')}",
                                rank=0, world_size=1)
        try:
            yield init_device_mesh("cpu", (1,), mesh_dim_names=("dof",))
        finally:
            dist.destroy_process_group()


def launch_beside(reference, fn, world, *args, timeout, join_timeout):
    """(every rank's result of ``fn``, ``reference()``): the gloo ranks run
    while this process computes the reference (the launcher only waits)."""
    from concurrent.futures import ThreadPoolExecutor

    from mathaudio_tpu_torch.parallel.launch import launch

    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch, fn, world, *args, backend="gloo", timeout=timeout,
                           join_timeout=join_timeout)
        ref = reference()
        return port.result(), ref


def _csr(d):
    from mathaudio_tpu_torch.solvers.sparse import CsrMatrix

    return CsrMatrix(d["indptr"], d["indices"], d["data"], tuple(d["shape"]))


def _mesh(world, name):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (world,), mesh_dim_names=(name,))


def _solution(sol):
    return dict(x=sol.x, iterations=int(sol.iterations), converged=bool(sol.converged),
                residual_norm=float(sol.residual_norm))


def krylov_axis_solves(mesh, a, h, b, x0, rank, world, cfg_kw):
    """Every Krylov entry point with ``axis_name`` on this rank's rows of a
    row-sharded dense system (cg on the Hermitian positive-definite ``h``):
    named by the mesh axis under ``use_mesh``, and once more with the
    process group itself."""
    from mathaudio_tpu_torch.parallel.mesh import use_mesh
    from mathaudio_tpu_torch.parallel.spmd import dense_rowblock_matvec
    from mathaudio_tpu_torch.solvers import krylov

    r = a.shape[0] // world
    rows = slice(rank * r, (rank + 1) * r)
    cfg = krylov.KrylovConfig(**cfg_kw)
    out = {}
    for name in KRYLOV_NAMES:
        m = torch.tensor((h if name == "cg" else a)[rows])
        b_l, x0_l = torch.tensor(b[rows]), torch.tensor(x0[rows])

        def mv(x):
            return dense_rowblock_matvec(m, x, "dof")

        for how, axis in (("name", "dof"), ("group", mesh.get_group("dof"))):
            args = (mv, b_l, x0_l) if name == "gmres_with_guess" else (mv, b_l)
            with use_mesh(mesh):
                sol = getattr(krylov, name)(*args, config=cfg, axis_name=axis)
            out[(name, how)] = _solution(sol)
    return out


def spmd_rank(rank, world, inp):
    """parallel/spmd.py and the axis_name solvers on this rank."""
    from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
    from mathaudio_tpu_torch.bem.types import BemSolverConfig, SolverMethod
    from mathaudio_tpu_torch.parallel.mesh import use_mesh
    from mathaudio_tpu_torch.parallel.spmd import (
        DeviceSchwarz,
        build_sharded_system,
        ell_allgather_matvec,
        ell_local_matvec,
        schwarz_apply_local,
        shard_dense_rows,
        shard_ell,
        sharded_dense_gmres_fn,
        sharded_gmres_fn,
    )
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres_pipelined_ghysels

    torch.manual_seed(0)
    mesh = _mesh(world, "dof")
    csr = _csr(inp["csr"])
    out = {}
    ell = shard_ell(csr, world, device="cpu")
    r = ell.rows_per_shard
    def local(v):  # this rank's rows of a vector padded to the shards
        return torch.tensor(np.concatenate([v, np.zeros(r * world - len(v), v.dtype)]))[
            rank * r:(rank + 1) * r]

    x_l = local(inp["x"])
    g_idx = ell.indices[rank] - ell.halo + rank * r  # global column indices
    with use_mesh(mesh):
        out["halo_y"] = ell_local_matvec(ell.indices[rank], ell.values[rank], x_l, ell.halo,
                                         "dof", world)
        out["allgather_y"] = ell_allgather_matvec(g_idx, ell.values[rank], x_l, "dof")
        dsz = DeviceSchwarz.from_csr(csr, world, 2, device="cpu")
        out["schwarz_y"] = schwarz_apply_local(
            dsz.gather_idx[rank], dsz.inv_blocks[rank], dsz.valid[rank], dsz.weights[rank],
            local(inp["r"]), dsz.overlap, "dof", world)

    cfg = KrylovConfig(**inp["gmres_cfg"])
    for label, c, overlap, kw in (
            ("schwarz", csr, 2, {}), ("none", _csr(inp["csr_easy"]), None, {}),
            ("ghysels", csr, 2, dict(config=KrylovConfig(**inp["ghysels_cfg"]),
                                     solver=gmres_pipelined_ghysels))):
        system = build_sharded_system(c, inp["rhs"], world, schwarz_overlap=overlap,
                                      device="cpu")
        solve = sharded_gmres_fn(mesh, **{"config": cfg, **kw})
        out[("sharded_gmres", label)] = _solution(solve(system))

    a_blocks, rhs_sh = shard_dense_rows(inp["dense_a"], inp["dense_rhs"], world, device="cpu")
    out["dense"] = _solution(sharded_dense_gmres_fn(mesh, KrylovConfig(**inp["dense_cfg"]))(
        a_blocks, rhs_sh))

    out["axis"] = krylov_axis_solves(mesh, inp["a"], inp["h"], inp["b"], inp["x0"], rank, world,
                                     inp["axis_cfg"])

    base = dict(method=SolverMethod.GMRES, tolerance=1e-9, max_iterations=400, restart=40)
    for kind, prob in (("rigid", BemProblem.rigid_sphere(1.5, subdivisions=2)),
                       ("mixed", BemProblem.radiating_sphere(1.0, subdivisions=1))):
        sol = BemSolver(BemSolverConfig(**base, device_mesh=mesh), dtype=F64,
                        device="cpu").solve(prob)
        out[("bem", kind)] = dict(p=sol.surface_pressure, info=sol.info)
    return out


def _room_sweep(dtype=F64):
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
    from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep

    meshes = box_hierarchy(4, 2)
    mg = GeometricMultigrid(meshes, robin_tags=(1, 2, 3, 4, 5, 6), dtype=dtype, device="cpu")
    model = RoomSweepModel(meshes[0], wall_tags=(1, 2, 3, 4, 5, 6), absorption=0.15,
                           listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)),
                           assembler=mg.assemblers[0])
    return NodeMajorRoomSweep(model, mg)


def sweep_rank(rank, world, inp):
    """NodeMajorRoomSweep.sharded_sweep_fn: cold, warm, and a band that
    does not split."""
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

    mesh = _mesh(world, "freq")
    nm = _room_sweep()
    cfg = KrylovConfig(**inp["cfg"])
    out = {}
    for label, knobs in inp["knobs"].items():
        p, its, conv = nm.sharded_sweep_fn(mesh, cfg, **knobs)(nm.params(), inp["ks"])
        out[label] = dict(p=p, its=its, conv=conv)
    try:
        nm.sharded_sweep_fn(mesh, cfg)(nm.params(), inp["ks"][:7])
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def slfmm_data(d):
    """Port SlfmmData from the reference's data as numpy arrays."""
    from mathaudio_tpu_torch.bem.fmm import SlfmmData

    return SlfmmData(*(None if d.get(f) is None else torch.tensor(np.asarray(d[f]))
                       for f in SlfmmData._fields))


def tree_data(d):
    """Port MlfmmTreeData (levels included) from the reference's data."""
    from mathaudio_tpu_torch.bem.fmm import MlfmmLevel, MlfmmTreeData

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a))

    levels = tuple(MlfmmLevel(*(t(lv.get(f)) for f in MlfmmLevel._fields)) for lv in d["levels"])
    return MlfmmTreeData(*(levels if f == "levels" else t(d.get(f))
                           for f in MlfmmTreeData._fields))


def fmm_rank(rank, world, inp):
    """parallel/fmm_spmd.py: the SLFMM and MLFMM-tree matvecs and solves
    over an 'fmm' axis, on the reference's operator data."""
    from mathaudio_tpu_torch.bem.fmm import (
        ClusterBlockPreconditioner,
        MlfmmTreeOperator,
        SlfmmOperator,
    )
    from mathaudio_tpu_torch.parallel.fmm_spmd import (
        shard_mlfmm_tree,
        shard_slfmm,
        sharded_mlfmm_tree_matvec_fn,
        sharded_mlfmm_tree_solve_fn,
        sharded_slfmm_matvec_fn,
        sharded_slfmm_solve_fn,
    )
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

    mesh = _mesh(world, "fmm")
    out = {}
    for label, data, op_cls, shard, mv_fn, solve_fn in (
            ("slfmm", slfmm_data(inp["slfmm"]), SlfmmOperator, shard_slfmm,
             sharded_slfmm_matvec_fn, sharded_slfmm_solve_fn),
            ("tree", tree_data(inp["tree"]), MlfmmTreeOperator, shard_mlfmm_tree,
             sharded_mlfmm_tree_matvec_fn, sharded_mlfmm_tree_solve_fn)):
        op = op_cls(data, int(data.diag_add.shape[0]))
        sharded = shard(data, world)
        out[(label, "y")] = mv_fn(mesh)(sharded, torch.tensor(inp[f"{label}_x"]))
        pre = ClusterBlockPreconditioner.from_operator(op)
        sol = solve_fn(mesh, KrylovConfig(**inp[f"{label}_cfg"]))(
            sharded, pre, torch.tensor(inp[f"{label}_rhs"]))
        out[(label, "solve")] = _solution(sol)
    return out


def parallel_rank(rank, world, inp):
    """parallel/mesh.py and parallel/de.py: the (freq x dof) mesh, the
    frequency-sharded ELL sweep, pmean_convergence, the DE population."""
    from mathaudio_tpu_torch.fem.mesh import unit_cube_tetrahedra
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel, sweep_pressure
    from mathaudio_tpu_torch.parallel import (
        pmean_convergence,
        shard_frequency_sweep,
        shard_population_eval,
        shard_room_params,
        sweep_mesh,
    )
    from mathaudio_tpu_torch.parallel.mesh import axis_index, axis_size, use_mesh
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig
    from mathaudio_tpu_torch.testfunctions import functions

    mesh = sweep_mesh(world, dof_parallel=inp["dof"], device_type="cpu")
    out = dict(shape=(axis_size(mesh, "freq"), axis_size(mesh, "dof")),
               coord=(axis_index(mesh, "freq"), axis_index(mesh, "dof")),
               names=tuple(mesh.mesh_dim_names))
    model = RoomSweepModel(unit_cube_tetrahedra(4), wall_tags=(1, 2, 3, 4, 5, 6), absorption=0.1,
                           listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)), dtype=F64,
                           device="cpu")
    cfg = KrylovConfig(**inp["cfg"])

    def step(params, ks):
        return sweep_pressure(params, ks, absorption=model.absorption, config=cfg,
                              num_nodes=model.num_nodes, ell_width=model.ell_width)

    out["sweep"] = shard_frequency_sweep(mesh, step)(shard_room_params(mesh, model.params()),
                                                    torch.tensor(inp["ks"]))
    with use_mesh(mesh):
        out["pmean"] = pmean_convergence(torch.tensor(inp["values"][axis_index(mesh, "freq")]))
    out["de"] = shard_population_eval(mesh, functions.rastrigin)(torch.tensor(inp["pop"]))
    return out


def failing_rank(rank, world):
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if rank == 1:
        raise ValueError("rank 1 gives up")
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)


def hanging_rank(rank, world):
    """Rank 1 never returns; rank 0 returns its rank at once."""
    if rank == 1:
        time.sleep(3600)
    return rank


def cuda_rank(rank, world, inp):
    """On card ``rank`` under NCCL: (a) the node-major sweep split by
    frequency lanes (DIA kernel) against the unsharded sweep of this
    rank's chunk on the same card; (b) BemSolver's device_mesh route
    (BEM pairwise kernel) against the unsharded GMRES solve."""
    from torch.distributed.device_mesh import init_device_mesh

    from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
    from mathaudio_tpu_torch.bem.types import BemSolverConfig, SolverMethod
    from mathaudio_tpu_torch.fem import dia
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
    from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
    from mathaudio_tpu_torch.ops import bem_assembly
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    meshes = box_hierarchy(inp["n"], 2)
    mg = GeometricMultigrid(meshes, robin_tags=(1, 2, 3, 4, 5, 6), dtype=torch.float32,
                            device=dev)
    nm = NodeMajorRoomSweep(RoomSweepModel(
        meshes[0], wall_tags=(1, 2, 3, 4, 5, 6), absorption=0.15,
        listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)), assembler=mg.assemblers[0]),
        mg)
    cfg = KrylovConfig(**inp["sweep_cfg"])
    ks = torch.linspace(0.55, 2.2, inp["lanes"] * world, dtype=torch.float32)
    fmesh = init_device_mesh("cuda", (world,), mesh_dim_names=("freq",))
    dia.reset_launches()
    p, its, conv = nm.sharded_sweep_fn(fmesh, cfg, **inp["knobs"])(nm.params(), ks)
    out["dia_launches"] = sum(dia.LAUNCHES.values())
    chunk = ks.reshape(world, -1)[rank]
    p1, its1, conv1 = nm.sweep_fn(cfg, **inp["knobs"])(nm.params(), chunk)
    lanes = slice(rank * inp["lanes"], (rank + 1) * inp["lanes"])
    out["sweep"] = dict(p=p, its=its, conv=conv, p_err=float(
        torch.max(torch.abs(p[lanes] - p1)) / torch.max(torch.abs(p1))),
        its_equal=bool(torch.equal(its[lanes], its1)), conv1=bool(conv1.all()))

    dmesh = init_device_mesh("cuda", (world,), mesh_dim_names=("dof",))
    for label, ka, bm in (("burton_miller", 2.0, True), ("cbie", 1.0, False)):
        prob = BemProblem.rigid_sphere(ka, subdivisions=inp["subdiv"])
        base = dict(method=SolverMethod.GMRES, tolerance=1e-5, restart=50, burton_miller=bm)
        bem_assembly.reset_launches()
        sh = BemSolver(BemSolverConfig(**base, device_mesh=dmesh), device=dev).solve(prob)
        launches = sum(bem_assembly.LAUNCHES.values())
        ref = BemSolver(BemSolverConfig(**base), device=dev).solve(prob)
        out[("bem", label)] = dict(
            info=sh.info, ref_info=ref.info, launches=launches,
            err=float(torch.linalg.norm(sh.surface_pressure - ref.surface_pressure)
                      / torch.linalg.norm(ref.surface_pressure)))
    return out
