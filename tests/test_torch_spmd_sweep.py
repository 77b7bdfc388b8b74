"""Port vs reference: NodeMajorRoomSweep.sharded_sweep_fn, the headline
node-major sweep split by frequency lanes, at 2 ranks here and at 4 in
test_torch_spmd_sweep_4ranks.py (a file of its own, so that a parallel test
run takes the two at once).

The port runs in gloo ranks spawned once per world size (rank function
``sweep_rank`` in ``_torch_parallel_ranks.py``) beside the reference, each
rank building the room
(box_hierarchy(4, 2), float64) and solving its contiguous chunk of 16
wavenumbers; the reference runs its ``shard_map`` over the first 2 or 4 of
conftest's 8 virtual CPU devices. Every rank returns the whole band
(all-gathered), held to the reference's: iterations and converged flags
equal, pressures within 1e-9 of max|p|, cold and with anchor warm starts;
a band that does not split raises the reference's ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_parallel_ranks import launch_beside, sweep_rank
from mathaudio_tpu.fem.multigrid import GeometricMultigrid, box_hierarchy
from mathaudio_tpu.models import RoomSweepModel
from mathaudio_tpu.models.room_sweep_nm import NodeMajorRoomSweep
from mathaudio_tpu.solvers import KrylovConfig

CFG = dict(max_iterations=60, tolerance=1e-6, restart=6)
KS = np.linspace(0.6, 2.1, 16)
COLD = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=2)
KNOBS = {"cold": COLD, "warm": dict(COLD, warm_stride=2, warm_restart=4, warm_interp="cubic")}


@pytest.fixture(scope="module")
def reference_sweep():
    meshes = box_hierarchy(4, 2)
    mg = GeometricMultigrid(meshes, robin_tags=(1, 2, 3, 4, 5, 6))
    model = RoomSweepModel(meshes[0], wall_tags=(1, 2, 3, 4, 5, 6), absorption=0.15,
                           listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)),
                           assembler=mg.assemblers[0])
    return NodeMajorRoomSweep(model, mg)


def run(s, nm):
    """(s, every rank's results, the reference's) at s ranks. The ranks took
    17 s (2) and 20 s (4) beside five other test workers; a rank still
    running at ``join_timeout`` (~4x that) fails the test."""
    fmesh = Mesh(np.asarray(jax.devices()[:s]), ("freq",))

    def reference():
        return {label: [np.asarray(a) for a in jax.jit(nm.sharded_sweep_fn(
            fmesh, KrylovConfig(**CFG), **knobs))(nm.params(), jnp.asarray(KS))]
            for label, knobs in KNOBS.items()}

    port, ref = launch_beside(reference, sweep_rank, s, dict(cfg=CFG, knobs=KNOBS, ks=KS),
                              timeout=70, join_timeout=80)
    return s, port, ref


@pytest.fixture(scope="module", params=[2], ids=["2ranks"])
def runs(request, reference_sweep):
    return run(request.param, reference_sweep)


@pytest.mark.parametrize("label", list(KNOBS))
def test_sharded_sweep_matches_reference(runs, label):
    s, port, ref = runs
    p_ref, its_ref, conv_ref = ref[label]
    assert conv_ref.all()
    for rank in range(s):
        got = port[rank][label]
        assert tuple(got["p"].shape) == p_ref.shape == (len(KS), 2)
        np.testing.assert_array_equal(got["its"].numpy(), its_ref)
        np.testing.assert_array_equal(got["conv"].numpy(), conv_ref)
        np.testing.assert_allclose(got["p"].numpy(), p_ref, rtol=0,
                                   atol=1e-9 * np.abs(p_ref).max())


def test_sharded_sweep_rejects_indivisible(runs, reference_sweep):
    s, port, _ = runs
    fmesh = Mesh(np.asarray(jax.devices()[:s]), ("freq",))
    fn = reference_sweep.sharded_sweep_fn(fmesh, KrylovConfig(**CFG))
    with pytest.raises(ValueError, match="do not split") as want:
        fn(reference_sweep.params(), jnp.asarray(KS[:7]))
    assert all(port[rank]["indivisible"] == str(want.value) for rank in range(s))
