"""Port vs reference: the node-major room sweep end to end.

``NodeMajorRoomSweep.sweep_fn`` of mathaudio_tpu_torch against
mathaudio_tpu's at n=8, 3 levels, 32 frequencies streamed in chunks of 16,
4 anchors, with the bench's solver knobs (CGS1, restart 6, V(1,1),
omega 1): cold here, and warm-started with stride 4 (cubic and linear) in
test_torch_room_sweep_nm_warm.py and test_torch_room_sweep_nm_warm_linear.py
(files of their own, so that a parallel test run takes them at once: each
reference takes ~10-25 s alone). Both
run on the CPU in float64; iterations and converged flags must be equal
lane for lane and pressures equal to 1e-9 of max|p|.

The reference runs eagerly (``jax.disable_jit``): the same operations
without compiling each variant's unrolled solver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mathaudio_tpu.fem.multigrid import GeometricMultigrid as JaxMultigrid
from mathaudio_tpu.fem.multigrid import box_hierarchy as jax_box_hierarchy
from mathaudio_tpu.models import RoomSweepModel as JaxRoomModel
from mathaudio_tpu.models.room_sweep_nm import NodeMajorRoomSweep as JaxNodeMajor
from mathaudio_tpu.solvers import KrylovConfig as JaxKrylovConfig
from mathaudio_tpu_torch.convert import node_major_params_from_numpy
from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
CONFIG = dict(max_iterations=500, tolerance=1e-5, restart=6)
KNOBS = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=4, gmres_orth="cgs1", freq_chunk=16)
WARM = {
    "cold": {},
    "warm_linear": dict(warm_stride=4, warm_restart=3, warm_interp="linear"),
    "warm_cubic": dict(warm_stride=4, warm_restart=3, warm_interp="cubic"),
}
KS = np.linspace(0.55, 2.2, 32)


@pytest.fixture(scope="module")
def sweeps():
    """Both builds, plus a per-variant cache of the reference's results."""
    jm = jax_box_hierarchy(8, 3)
    jmg = JaxMultigrid(jm, robin_tags=WALLS)
    jnm = JaxNodeMajor(JaxRoomModel(jm[0], assembler=jmg.assemblers[0], **ROOM), jmg)
    tm = box_hierarchy(8, 3)
    tmg = GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu")
    tnm = NodeMajorRoomSweep(RoomSweepModel(tm[0], assembler=tmg.assemblers[0], **ROOM), tmg)
    cache = {}

    def reference(variant):
        if variant not in cache:
            fn = jnm.sweep_fn(JaxKrylovConfig(**CONFIG), **KNOBS, **WARM[variant])
            with jax.disable_jit():
                p, its, conv = fn(jnm.params(), jnp.asarray(KS))
            cache[variant] = (np.asarray(p), np.asarray(its), np.asarray(conv))
        return cache[variant]

    return jnm, tnm, reference


def _assert_matches(got, ref):
    p, its, conv = (t.numpy() for t in got)
    rp, rits, rconv = ref
    assert p.shape == rp.shape == (len(KS), 2)
    np.testing.assert_array_equal(its, rits)
    np.testing.assert_array_equal(conv, rconv)
    assert conv.all()
    np.testing.assert_allclose(p, rp, rtol=0, atol=1e-9 * np.abs(rp).max())


# the variants that test_torch_room_sweep_nm_warm.py and
# test_torch_room_sweep_nm_warm_linear.py run
CUBIC, LINEAR = ["warm_cubic"], ["warm_linear"]


@pytest.fixture(params=[v for v in sorted(WARM) if v not in CUBIC + LINEAR])
def variant(request):
    return request.param


def test_sweep_matches_reference(sweeps, variant):
    _, tnm, reference = sweeps
    fn = tnm.sweep_fn(KrylovConfig(**CONFIG), **KNOBS, **WARM[variant])
    got = fn(tnm.params(), KS)
    _assert_matches(got, reference(variant))
    if variant != "cold":  # anchor lanes carry phase-1 + phase-2 iterations
        its = got[1].numpy()
        assert (its[::4] > its.reshape(-1, 4)[:, 1:].min(axis=1)).all()


def test_converted_params_reproduce_reference(sweeps):
    jnm, tnm, reference = sweeps
    tree = jax.tree_util.tree_map(np.asarray, jnm.params())
    params = node_major_params_from_numpy(tree, device="cpu", dtype=torch.float64)
    assert params.offsets == tnm.offsets
    fn = tnm.sweep_fn(KrylovConfig(**CONFIG), **KNOBS)
    _assert_matches(fn(params, KS), reference("cold"))


def test_anchor_count_rounds_to_divisor(sweeps):
    _, tnm, _ = sweeps
    fn = tnm.sweep_fn(KrylovConfig(**CONFIG), mg_nu=1, mg_omega=1.0, mg_coarse_anchors=3)
    with pytest.warns(UserWarning, match="does not divide"):
        _, _, conv = fn(tnm.params(), KS[:8])
    assert conv.all()


@pytest.mark.parametrize("knobs,match", [
    (dict(warm_stride=3), "warm_stride"),
    (dict(freq_chunk=3), "freq_chunk"),
])
def test_band_splits_must_divide(sweeps, knobs, match):
    _, tnm, _ = sweeps
    with pytest.raises(ValueError, match=match):
        tnm.sweep_fn(KrylovConfig(**CONFIG), **knobs)(tnm.params(), KS[:10])


@pytest.mark.parametrize("knobs,match", [
    (dict(gmres_orth="mgs"), "orthogonalization"),
    (dict(warm_stride=4, warm_interp="spline"), "warm_interp"),
])
def test_unported_options_rejected(sweeps, knobs, match):
    _, tnm, _ = sweeps
    with pytest.raises(ValueError, match=match):
        tnm.sweep_fn(**knobs)


def test_unstructured_sparsity_rejected():
    from types import SimpleNamespace

    rng = np.random.default_rng(3)
    n, nnz = 200, 600
    asm = SimpleNamespace(
        row_of_slot=torch.as_tensor(rng.integers(0, n, nnz)),
        col_of_slot=torch.as_tensor(rng.integers(0, n, nnz)),
        num_nodes=n,
    )
    with pytest.raises(ValueError, match="node-major DIA"):
        NodeMajorRoomSweep._check_structured(asm)
