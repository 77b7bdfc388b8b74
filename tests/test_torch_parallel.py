"""Port vs reference: parallel/mesh.py and parallel/de.py (the (freq x dof)
mesh, the frequency-sharded ELL room sweep with the room parameters placed
on it, pmean_convergence, the population-sharded DE evaluation), and the
port's multi-rank dry run (parallel/dryrun.py).

The port runs in gloo ranks spawned once per case (rank function
``parallel_rank`` in ``_torch_parallel_ranks.py``): 2 ranks on a (2 x 1)
mesh and 4 on a (2 x 2) one; the reference shards the same seeded inputs
over the first 2 or 4 of conftest's 8 virtual CPU devices, in float64.
Every rank's gathered pressures, iterations and converged flags are the
reference's (pressures within 1e-9 of max|p|), the DE energies within
1e-12, the mean exact to rounding. The dry run at 8 ranks reproduces the
iteration counts of the reference's recorded 8-device run
(MULTICHIP_r05.json).
"""

import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_parallel_ranks import failing_rank, hanging_rank, launch_beside, parallel_rank
from mathaudio_tpu.fem.mesh import unit_cube_tetrahedra
from mathaudio_tpu.models import RoomSweepModel
from mathaudio_tpu.models.helmholtz_room import sweep_pressure
from mathaudio_tpu.parallel import (
    pmean_convergence,
    shard_frequency_sweep,
    shard_population_eval,
    shard_room_params,
    sweep_mesh,
)
from mathaudio_tpu.solvers import KrylovConfig
from mathaudio_tpu.testfunctions import functions as F
from mathaudio_tpu_torch.parallel.dryrun import dryrun_multichip
from mathaudio_tpu_torch.parallel.launch import launch

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(max_iterations=400, tolerance=1e-8, restart=20)
KS = np.linspace(0.6, 1.8, 8)
POP = np.random.default_rng(0).uniform(-5, 5, (64, 4))


@pytest.fixture(scope="module")
def room():
    return RoomSweepModel(unit_cube_tetrahedra(4), wall_tags=(1, 2, 3, 4, 5, 6), absorption=0.1,
                          listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))


def _reference(room, mesh, values):
    cfg = KrylovConfig(**CFG)

    def sweep(params, ks):
        return sweep_pressure(params, ks, absorption=room.absorption, config=cfg,
                              num_nodes=room.num_nodes, ell_width=room.ell_width)

    with mesh:
        ref_sweep = [np.asarray(a) for a in shard_frequency_sweep(mesh, sweep)(
            shard_room_params(mesh, room.params()), jnp.asarray(KS))]
        ref_de = np.asarray(shard_population_eval(mesh, F.rastrigin)(jnp.asarray(POP)))
    ref_pmean = np.asarray(jax.jit(jax.shard_map(
        lambda v: pmean_convergence(v, "freq"), mesh=mesh, in_specs=P("freq"), out_specs=P(),
        check_vma=False))(jnp.asarray(values)))
    return dict(sweep=ref_sweep, de=ref_de, pmean=ref_pmean)


@pytest.fixture(scope="module", params=[(2, 1), (4, 2)], ids=["2x1", "2x2"])
def runs(request, room):
    """The ranks took 10 s (2) and 12 s (4) beside five other test workers;
    a rank still running at ``join_timeout`` (~4x that) fails the test."""
    world, dof = request.param
    values = np.arange(1.0, world // dof + 1.0) ** 2
    mesh = sweep_mesh(world, dof_parallel=dof)
    port, ref = launch_beside(lambda: _reference(room, mesh, values), parallel_rank, world,
                              dict(dof=dof, cfg=CFG, ks=KS, values=values, pop=POP),
                              timeout=40, join_timeout=50)
    return world, dof, mesh, port, ref


def test_mesh_axes_and_coordinates(runs):
    world, dof, mesh, port, _ = runs
    grid = np.asarray(mesh.devices)
    for rank in range(world):
        assert port[rank]["names"] == mesh.axis_names == ("freq", "dof")
        assert port[rank]["shape"] == grid.shape == (world // dof, dof)
        # rank r sits where the reference's mesh puts device r
        assert grid[port[rank]["coord"]] == jax.devices()[rank]


def test_frequency_sharded_sweep(runs):
    world, _, _, port, ref = runs
    p_ref, its_ref, conv_ref = ref["sweep"]
    assert conv_ref.all()
    for rank in range(world):
        p, its, conv = (t.numpy() for t in port[rank]["sweep"])
        np.testing.assert_array_equal(its, its_ref)
        np.testing.assert_array_equal(conv, conv_ref)
        np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-9 * np.abs(p_ref).max())


def test_pmean_convergence(runs):
    world, _, _, port, ref = runs
    for rank in range(world):
        np.testing.assert_allclose(port[rank]["pmean"].numpy(), ref["pmean"], rtol=1e-15)


def test_population_sharded_de_eval(runs):
    world, _, _, port, ref = runs
    np.testing.assert_allclose(ref["de"], np.asarray(jax.vmap(F.rastrigin)(jnp.asarray(POP))),
                               rtol=1e-12)
    for rank in range(world):
        np.testing.assert_allclose(port[rank]["de"].numpy(), ref["de"], rtol=1e-12)


def test_dryrun_at_8_ranks_matches_the_recorded_reference():
    # launch's default join_timeout (180 s) bounds the 8 ranks (47 s beside
    # five other test workers)
    line = dryrun_multichip(8, "cpu")
    recorded = json.loads((ROOT / "MULTICHIP_r05.json").read_text())["tail"]
    fields = dict(f.split("=", 1) for f in line.split(": ", 1)[1].split() if "=" in f)
    want = dict(f.split("=", 1) for f in recorded.split(": ", 1)[1].split() if "=" in f)
    assert line.startswith("dryrun_multichip OK: ")
    for key in ("mesh", "devices", "spmd_gmres_iters", "fmm_sharded_iters",
                "mlfmm_tree_sharded_iters"):
        assert fields[key] == want[key], (key, line, recorded)
    assert float(fields["nodemajor_sharded_maxerr"]) == 0.0
    for key in ("fmm_sharded_err", "mlfmm_tree_sharded_err"):
        assert float(fields[key]) < 1e-8


def test_launch_stops_the_peers_of_a_failed_rank():
    # rank 0 waits in a collective that rank 1 never joins: the launch
    # raises rank 1's error (in ~4 s) well before the process group's timeout
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        launch(failing_rank, 2, backend="gloo", timeout=120, join_timeout=180)
    assert time.monotonic() - t0 < 60
    msg = str(err.value)
    assert msg.index("rank 1 failed:") < msg.index("rank 0 ")  # the first failure leads
    assert "ValueError: rank 1 gives up" in msg


def test_launch_stops_a_rank_that_never_returns():
    # rank 1 sleeps for an hour: the launch stops it at join_timeout and
    # names it, with the stack it dumped on the way out. On a loaded host
    # both ranks may still be starting at 6 s (rank 0 then times out too,
    # and a rank that had not yet reached its function dumps no stack)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        launch(hanging_rank, 2, backend="gloo", timeout=5, join_timeout=6)
    assert time.monotonic() - t0 < 6 + 3
    msg = str(err.value)
    head = "rank 1 timed out after 6 s without a result"
    assert head in msg
    rest = msg.split(head, 1)[1]
    assert rest.startswith(("; its stack:\n", "; it dumped no stack"))
    if rest.startswith("; its stack:"):
        assert "in _child" in rest  # the rank's own frames
    if "rank 0 " not in msg:  # rank 0 returned, so rank 1 had reached its function
        assert "in hanging_rank" in rest
