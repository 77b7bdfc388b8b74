"""Port vs reference: the node-major sweep with the streamed transfers on
bfloat16 re/im planes, and the Jacobi-preconditioned sweep.

At n=8, 3 levels, 8 frequencies in [0.55, 2.2], on the CPU in float64.

``mg_transfers="stream16"`` (4 anchors, V(1,1), omega 1, GMRES restart 8,
tol 1e-6): the planes round the preconditioner's transfers (~4e-3), and
torch rounds each bfloat16 op where XLA may keep float32 inside a fusion,
so the contract is the reference's own for stream16
(tests/test_nodemajor.py): every lane converged, pressures within 1e-3 of
max|p| of the exact-transfer sweep; and against the reference's stream16
sweep, iterations within one per lane and pressures within 1e-3 of max|p|.

``sweep_fn_jacobi`` on walls of admittance 2 (restart 8, at most 400
iterations: 61-114 iterations, several restart cycles; at 0.15
Jacobi-GMRES(8) converges no lane within 400): iterations and converged
flags lane for lane, pressures to 1e-9 of max|p|.

The reference's sweeps run jitted (eagerly stream16's ~60 iterations take
longer than its compile; Jacobi's restart-8 cycle compiles in seconds);
torch runs on one thread.
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
from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

torch.set_num_threads(1)

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
CONFIG = dict(max_iterations=60, tolerance=1e-6, restart=8)
JACOBI_CONFIG = dict(max_iterations=400, tolerance=1e-6, restart=8)
KNOBS = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=4)
KS = np.linspace(0.55, 2.2, 8)


@pytest.fixture(scope="module")
def hierarchies():
    jm = jax_box_hierarchy(8, 3)
    tm = box_hierarchy(8, 3)
    return (jm, JaxMultigrid(jm, robin_tags=WALLS),
            tm, GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu"))


def _sweeps(hierarchies, absorption):
    jm, jmg, tm, tmg = hierarchies
    jnm = JaxNodeMajor(JaxRoomModel(jm[0], assembler=jmg.assemblers[0], absorption=absorption,
                                    **ROOM), jmg)
    tnm = NodeMajorRoomSweep(RoomSweepModel(tm[0], assembler=tmg.assemblers[0],
                                            absorption=absorption, **ROOM), tmg)
    return jnm, tnm


def test_stream16_sweep_matches_reference_and_exact_transfers(hierarchies):
    jnm, tnm = _sweeps(hierarchies, 0.15)
    fn = jax.jit(jnm.sweep_fn(JaxKrylovConfig(**CONFIG), **KNOBS, mg_transfers="stream16"))
    rp, rits, rconv = (np.asarray(a) for a in fn(jnm.params(), jnp.asarray(KS)))
    p, its, conv = (t.numpy() for t in tnm.sweep_fn(
        KrylovConfig(**CONFIG), **KNOBS, mg_transfers="stream16")(tnm.params(), KS))
    gp, _, gconv = (t.numpy() for t in tnm.sweep_fn(
        KrylovConfig(**CONFIG), **KNOBS)(tnm.params(), KS))
    assert conv.all() and rconv.all() and gconv.all()
    assert np.abs(its - rits).max() <= 1, (its, rits)
    np.testing.assert_allclose(p, rp, rtol=0, atol=1e-3 * np.abs(rp).max())
    np.testing.assert_allclose(p, gp, rtol=0, atol=1e-3 * np.abs(gp).max())


def test_jacobi_sweep_matches_reference(hierarchies):
    jnm, tnm = _sweeps(hierarchies, 2.0)
    rp, rits, rconv = (np.asarray(a) for a in jax.jit(jnm.sweep_fn_jacobi(
        JaxKrylovConfig(**JACOBI_CONFIG)))(jnm.params(), jnp.asarray(KS)))
    p, its, conv = (t.numpy() for t in tnm.sweep_fn_jacobi(KrylovConfig(**JACOBI_CONFIG))(
        tnm.params(), KS))
    assert p.shape == rp.shape == (len(KS), 2)
    np.testing.assert_array_equal(its, rits)
    np.testing.assert_array_equal(conv, rconv)
    assert conv.all()
    assert its.min() > 3 * JACOBI_CONFIG["restart"]  # several restart cycles
    np.testing.assert_allclose(p, rp, rtol=0, atol=1e-9 * np.abs(rp).max())
