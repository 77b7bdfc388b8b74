"""The port's layer record (``mathaudio_tpu_torch.utils.profiling``):
regions, counters and tallies that record exactly while a torch.profiler
session records, at the sites of the FEM room sweep and the dense BEM
sweep. On the CPU, at tiny shapes: nothing is recorded without a
profiler and the answers are the same bits either way; the regions land
in the profiler's trace, ``gmres`` around ``mg.cycle``; the counters
equal hand counts; self time is duration less the children's union.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from mathaudio_tpu_torch.bem import sweep
from mathaudio_tpu_torch.bem.incident import plane_wave
from mathaudio_tpu_torch.bem.mesh import icosphere
from mathaudio_tpu_torch.fem import multigrid
from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig
from mathaudio_tpu_torch.solvers.krylov_batched import gmres_batched
from mathaudio_tpu_torch.utils import profiling

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
# the benchmark's FEM knobs at a tiny size: 32 lanes in chunks of 16, 4
# anchors a chunk, warm stride 4
KNOBS = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=4, gmres_orth="cgs1", freq_chunk=16,
             warm_stride=4, warm_restart=3, warm_interp="cubic")
KS_FEM = np.linspace(0.55, 2.2, 32)
KS_BEM = np.linspace(0.5, 3.0, 3)


@pytest.fixture(autouse=True)
def _fresh_record():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _profiled(fn):
    """(fn(), the profiler) with fn run under a CPU profiler session."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def fem_sweep():
    meshes = box_hierarchy(8, 3)
    mg = GeometricMultigrid(meshes, robin_tags=WALLS, dtype=torch.float64, device="cpu")
    nm = NodeMajorRoomSweep(RoomSweepModel(meshes[0], assembler=mg.assemblers[0], **ROOM), mg)
    fn = nm.sweep_fn(KrylovConfig(max_iterations=500, tolerance=1e-5, restart=6), **KNOBS)
    params = nm.params()
    return lambda: fn(params, torch.as_tensor(KS_FEM))


@pytest.fixture(scope="module")
def bem_sweep():
    mesh = icosphere(1.0, 2)
    statics = sweep.sweep_statics(mesh, dtype=torch.float64, device="cpu")
    ks = torch.as_tensor(KS_BEM)

    def run(row_block=-1, solver="gmres"):
        betas, rhs = sweep.sweep_inputs(mesh, statics, ks, plane_wave((0.0, 0.6, 0.8)),
                                        burton_miller=True)
        return (sweep.sweep_apply(statics, ks, betas, rhs, burton_miller=True,
                                  row_block=row_block, solver=solver),)

    return run


@pytest.mark.parametrize("which", ["fem", "bem"])
def test_nothing_recorded_without_a_profiler_and_the_same_bits_with_one(
        fem_sweep, bem_sweep, which):
    run = fem_sweep if which == "fem" else bem_sweep
    plain = run()
    assert profiling.snapshot() == {"regions": {}, "counters": {}, "tallies": {}}
    traced, _ = _profiled(run)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
    snap = profiling.snapshot()
    assert snap["regions"]["gmres"]["calls"] >= 1 and snap["counters"]["gmres.matvecs"] > 0


def test_the_profilers_warm_up_step_records_nothing():
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        with profiling.region("warm"):
            profiling.count("warm")
        assert profiling.snapshot()["regions"] == {}
        prof.step()
        with profiling.region("active"):
            profiling.count("active", 2)
        prof.step()
    snap = profiling.snapshot()
    assert list(snap["regions"]) == ["active"] and snap["counters"] == {"active": 2}


def test_fem_regions_land_in_the_trace_gmres_around_the_cycles(fem_sweep):
    _, prof = _profiled(fem_sweep)
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert {"gmres", "mg.cycle", "mg.coarse_chain"} <= set(spans)
    for s, e in spans["mg.cycle"]:
        assert any(gs <= s and e <= ge for gs, ge in spans["gmres"])
    for s, e in spans["mg.coarse_chain"]:  # built before each solve, outside it
        assert not any(gs <= s and e <= ge for gs, ge in spans["gmres"])
    snap = profiling.snapshot()
    regions, counters = snap["regions"], snap["counters"]
    # 2 chunks x (anchor solve + warm solve); one coarse chain per solve
    assert regions["gmres"]["calls"] == 4 == regions["mg.coarse_chain"]["calls"]
    # one preconditioner cycle for M b and one after every operator application
    assert regions["mg.cycle"]["calls"] == counters["gmres.matvecs"] + 4
    assert 0 < regions["gmres"]["self_ms"] < regions["gmres"]["ms"]
    assert len(spans["mg.cycle"]) == regions["mg.cycle"]["calls"]


def _system(n=20, nf=3, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn(nf, n, n, dtype=torch.complex128, generator=g)
    a = 4.0 * torch.eye(n, dtype=torch.complex128) + scale * noise / math.sqrt(n)
    b = torch.randn(n, nf, dtype=torch.complex128, generator=g)
    return (lambda v: torch.einsum("fij,jf->if", a, v)), b


# (name, scale of the off-diagonal part, tolerance, max iterations, x0, vmapped,
#  expected (cycles, matvecs, host_sync.gmres)); restart 4 throughout
GMRES_CASES = [
    # an unreachable tolerance: three whole cycles, then the budget ends
    ("budget", 1.0, 0.0, 12, False, False, (3, 3 * 4 + 2, 3)),
    ("budget_warm", 1.0, 0.0, 12, True, False, (3, 1 + 3 * 4 + 2, 3)),
    ("budget_vmapped", 1.0, 0.0, 12, False, True, (3, 3 * 4 + 2, 3 + 3 * 4)),
    # A = 4 I: every lane converges at the first step; lockstep still
    # takes the cycle's 4 steps, vmapped stops at the second step's check
    ("identity", 0.0, 1e-8, 40, False, False, (1, 4, 1)),
    ("identity_vmapped", 0.0, 1e-8, 40, False, True, (1, 1, 2 + 1)),
]


@pytest.mark.parametrize("name,scale,tol,max_it,warm,vmapped,expected", GMRES_CASES,
                         ids=[c[0] for c in GMRES_CASES])
def test_gmres_counts_cycles_matvecs_and_host_reads(name, scale, tol, max_it, warm, vmapped,
                                                    expected):
    a_mv, b = _system(scale=scale)
    cfg = KrylovConfig(max_iterations=max_it, tolerance=tol, restart=4)
    x0 = torch.ones_like(b) if warm else None
    _, prof = _profiled(lambda: gmres_batched(a_mv, b, cfg, x0=x0, vmapped=vmapped))
    counters = profiling.snapshot()["counters"]
    cycles, matvecs, checks = expected
    assert (counters["gmres.cycles"], counters["gmres.matvecs"],
            counters["host_sync.gmres"]) == (cycles, matvecs, checks)
    assert counters["host_sync.upload"] == 1  # the tolerance


def test_bem_lane_iterations_are_gmres_own(bem_sweep, monkeypatch):
    solutions = []

    def kept(*args, **kwargs):
        solutions.append(gmres_batched(*args, **kwargs))
        return solutions[-1]

    monkeypatch.setattr(sweep, "gmres_batched", kept)
    _profiled(bem_sweep)
    snap = profiling.snapshot()
    assert len(solutions) == 1
    assert snap["tallies"]["bem.gmres.lane_iterations"] == int(solutions[0].iterations.sum())
    assert snap["counters"]["bem.gmres.lanes"] == len(KS_BEM)
    assert snap["counters"]["gmres.matvecs"] >= int(solutions[0].iterations.max())


@pytest.mark.parametrize("row_block", [0, 64, 100, 320, 500])
def test_bem_row_chunks_cover_the_rows(bem_sweep, row_block):
    n = 320
    _profiled(lambda: bem_sweep(row_block=row_block, solver="lu"))
    snap = profiling.snapshot()
    chunks = 1 if row_block <= 0 or row_block >= n else math.ceil(n / row_block)
    assert snap["counters"]["bem.row_chunks"] == chunks
    assert snap["regions"]["bem.assemble"]["calls"] == 1


@pytest.fixture(scope="module")
def coarse_builder():
    meshes = box_hierarchy(4, 2)
    return GeometricMultigrid(meshes, robin_tags=WALLS, dtype=torch.float64,
                              device="cpu").builder


# (anchors, newton steps): Newton steps refine each inverse from its
# neighbour's; with none, most anchors fail the check and are inverted
@pytest.mark.parametrize("anchors,newton", [(4, 3), (6, 0), (1, 3)])
def test_coarse_chain_counts_anchor_checks_and_direct_inverses(coarse_builder, monkeypatch,
                                                               anchors, newton):
    inverses = []
    inv = torch.linalg.inv

    def counted(a):
        inverses.append(a.shape)
        return inv(a)

    monkeypatch.setattr(torch.linalg, "inv", counted)
    ks = torch.linspace(0.6, 6.0, anchors, dtype=torch.float64)
    coeffs = (-0.15j * ks).to(torch.complex128)
    _profiled(lambda: multigrid.build_coarse_inv_chain(coarse_builder, ks, coeffs,
                                                       newton_steps=newton))
    snap = profiling.snapshot()
    assert snap["counters"]["host_sync.coarse_chain"] == anchors + len(inverses)
    assert snap["regions"]["mg.coarse_chain"]["calls"] == 1
    if newton == 0 and anchors > 1:
        assert len(inverses) > 1  # the fallback ran


# Scripted host clock, one reading per stamp (seconds), and the regions
# opened: each entry (name, children); expected {name: (calls, ms, self ms)}.
SELF_CASES = {
    "flat": ([0.0, 2.0], [("a", [])], {"a": (1, 2000.0, 2000.0)}),
    "nested": ([0.0, 1.0, 1.5, 2.5, 3.0, 6.0, 8.0, 10.0],
               [("outer", [("child", [("grandchild", [])]), ("child", [])])],
               {"outer": (1, 10000.0, 6000.0), "child": (2, 4000.0, 3000.0),
                "grandchild": (1, 1000.0, 1000.0)}),
    "siblings": ([0.0, 1.0, 4.0, 5.0, 5.0, 7.0],
                 [("a", [("b", [])]), ("c", [])],
                 {"a": (1, 5000.0, 2000.0), "b": (1, 3000.0, 3000.0), "c": (1, 2000.0, 2000.0)}),
}


@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_self_time_is_duration_less_the_childrens_union(monkeypatch, case):
    clock, tree, expected = SELF_CASES[case]
    readings = iter(clock)
    rec = profiling.Recorder()

    def open_all(nodes):
        for name, children in nodes:
            with rec.region(name):
                open_all(children)

    with profile(activities=[ProfilerActivity.CPU]), monkeypatch.context() as m:
        m.setattr(profiling.time, "perf_counter", lambda: next(readings))
        open_all(tree)
    assert next(readings, None) is None
    regions = rec.snapshot()["regions"]
    assert {k: (v["calls"], v["ms"], v["self_ms"]) for k, v in regions.items()} == \
        pytest.approx(expected)


def test_counters_and_tallies_sum_and_reset():
    rec = profiling.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        rec.count("n")
        rec.count("n", 4)
        rec.tally("t", torch.tensor([1, 2, 3], dtype=torch.int32))
        rec.tally("t", torch.tensor([10], dtype=torch.int32))
    snap = rec.snapshot()
    assert snap["counters"] == {"n": 5} and snap["tallies"] == {"t": 16}
    rec.reset()
    assert rec.snapshot() == {"regions": {}, "counters": {}, "tallies": {}}
