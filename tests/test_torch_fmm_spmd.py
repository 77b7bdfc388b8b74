"""Port vs reference: parallel/fmm_spmd.py, the cluster-sharded SLFMM and
the per-level sharded MLFMM tree, their matvecs and GMRES solves, at 2 and
4 ranks.

The reference builds each operator (an SLFMM of the 320-element icosphere
at k = 2 with Burton–Miller beta = i/k; an MLFMM tree of the 1280-element
icosphere at k = 4, 16 elements per leaf; both at the stability screen
tau = 1e4, float64). Its operator data, carried across as numpy arrays, is
what the port's gloo ranks shard (rank function ``fmm_rank`` in
``_torch_parallel_ranks.py``), so the comparison sees the sharding and not
the two packages' builds. The reference runs its ``shard_map`` over the
first 2 or 4 of conftest's 8 virtual CPU devices. Every rank's replicated
output is held to the reference's: matvecs within 1e-12 of max|y|, solves
within 1e-9 of max|x| with equal iteration counts, both converged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_parallel_ranks import fmm_rank, launch_beside
from mathaudio_tpu.bem import plane_wave
from mathaudio_tpu.bem.fmm import (
    ClusterBlockPreconditioner,
    MlfmmLevel,
    build_mlfmm_tree_system,
    build_slfmm_system,
)
from mathaudio_tpu.bem.mesh import icosphere
from mathaudio_tpu.parallel import fmm_spmd as jax_fmm_spmd
from mathaudio_tpu.solvers import KrylovConfig

SLFMM_CFG = dict(max_iterations=150, tolerance=1e-8, restart=40)
TREE_CFG = dict(max_iterations=200, tolerance=1e-8, restart=50)


def _numpy(data):
    """A reference data NamedTuple as a dict of numpy arrays (levels as a
    list of dicts)."""
    out = {}
    for f in data._fields:
        v = getattr(data, f)
        if f == "levels":
            out[f] = [{g: (None if getattr(lv, g) is None else np.asarray(getattr(lv, g)))
                       for g in MlfmmLevel._fields} for lv in v]
        else:
            out[f] = None if v is None else np.asarray(v)
    return out


@pytest.fixture(scope="module")
def operators():
    inc = plane_wave((0.0, 0.0, 1.0))
    rng = np.random.default_rng(0)
    surf, k = icosphere(1.0, 2), 2.0
    slfmm = build_slfmm_system(surf, k, beta=1j / k, stability_tau=1e4)
    c, nrm = jnp.asarray(surf.centers), jnp.asarray(surf.normals)
    slfmm_rhs = inc.pressure(c, k) - (1j / k) * inc.normal_derivative(c, nrm, k)
    surf5, k5 = icosphere(1.0, 3), 4.0
    tree = build_mlfmm_tree_system(surf5, k5, max_per_leaf=16, stability_tau=1e4)
    tree_rhs = inc.pressure(jnp.asarray(surf5.centers), k5)
    inputs = dict(
        slfmm=_numpy(slfmm.data), tree=_numpy(tree.data),
        slfmm_x=rng.normal(size=slfmm.n) + 1j * rng.normal(size=slfmm.n),
        tree_x=rng.normal(size=tree.n) + 1j * rng.normal(size=tree.n),
        slfmm_rhs=np.asarray(slfmm_rhs), tree_rhs=np.asarray(tree_rhs),
        slfmm_cfg=SLFMM_CFG, tree_cfg=TREE_CFG)
    return dict(slfmm=slfmm, tree=tree), inputs


def _reference(ops, inputs, s):
    mesh = Mesh(np.asarray(jax.devices()[:s]), ("fmm",))
    ref = {}
    for label, shard, mv_fn, solve_fn in (
            ("slfmm", jax_fmm_spmd.shard_slfmm, jax_fmm_spmd.sharded_slfmm_matvec_fn,
             jax_fmm_spmd.sharded_slfmm_solve_fn),
            ("tree", jax_fmm_spmd.shard_mlfmm_tree, jax_fmm_spmd.sharded_mlfmm_tree_matvec_fn,
             jax_fmm_spmd.sharded_mlfmm_tree_solve_fn)):
        op = ops[label]
        sharded = shard(op.data, s)
        ref[(label, "y")] = np.asarray(jax.jit(mv_fn(mesh))(sharded,
                                                            jnp.asarray(inputs[f"{label}_x"])))
        pre = ClusterBlockPreconditioner.from_operator(op)
        cfg = KrylovConfig(**inputs[f"{label}_cfg"])
        ref[(label, "solve")] = jax.jit(solve_fn(mesh, cfg))(sharded, pre,
                                                             jnp.asarray(inputs[f"{label}_rhs"]))
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def runs(request, operators):
    """(s, every rank's results, the reference's) at s ranks. The ranks took
    26 s (2) and 24 s (4) beside five other test workers; a rank still
    running at ``join_timeout`` (~4x that) fails the test."""
    s = request.param
    ops, inputs = operators
    port, ref = launch_beside(lambda: _reference(ops, inputs, s), fmm_rank, s, inputs,
                              timeout=100, join_timeout=110)
    return s, port, ref


@pytest.mark.parametrize("label", ["slfmm", "tree"])
def test_sharded_matvec_matches_reference(runs, label):
    s, port, ref = runs
    want = ref[(label, "y")]
    for rank in range(s):
        got = port[rank][(label, "y")].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("label", ["slfmm", "tree"])
def test_sharded_solve_matches_reference(runs, label):
    s, port, ref = runs
    want = ref[(label, "solve")]
    assert bool(want.converged)
    x = np.asarray(want.x)
    for rank in range(s):
        got = port[rank][(label, "solve")]
        assert got["converged"] and got["iterations"] == int(want.iterations)
        np.testing.assert_allclose(got["x"].numpy(), x, rtol=0, atol=1e-9 * np.abs(x).max())
