"""Port vs reference: the node-major sweep with each multigrid option.

``NodeMajorRoomSweep.sweep_fn`` of mathaudio_tpu_torch against
mathaudio_tpu's with the same option, at n=8, 3 levels, 8 frequencies in
[0.55, 2.2], 4 anchors, nu 1, omega 1, GMRES restart 8, tol 1e-6, on the
CPU in float64: the tensor-product (``mg_transfers="tp"``) and streamed
(``"stream"``) transfers, each also against the port's gather sweep (the
same operator), and the W and F cycles; the streamed transfers run in
test_torch_mg_sweeps_stream.py (a file of its own, so that a parallel test
run takes the two at once). Iterations and converged flags
lane for lane, pressures to 1e-9 of max|p|. The stream16 and Jacobi sweeps
are in tests/test_torch_mg_jit_sweeps.py.

The reference's sweeps run eagerly (``jax.disable_jit``: the first pays
for compiling each primitive once, the others reuse them), on one build
per module; torch runs on one thread.
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
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
CONFIG = dict(max_iterations=60, tolerance=1e-6, restart=8)
KNOBS = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=4)
KS = np.linspace(0.55, 2.2, 8)


@pytest.fixture(scope="module")
def sweeps():
    jm = jax_box_hierarchy(8, 3)
    jmg = JaxMultigrid(jm, robin_tags=WALLS)
    jnm = JaxNodeMajor(JaxRoomModel(jm[0], assembler=jmg.assemblers[0], **ROOM), jmg)
    tm = box_hierarchy(8, 3)
    tmg = GeometricMultigrid(tm, robin_tags=WALLS, dtype=torch.float64, device="cpu")
    tnm = NodeMajorRoomSweep(RoomSweepModel(tm[0], assembler=tmg.assemblers[0], **ROOM), tmg)
    return jnm, tnm


def _assert_matches(got, ref):
    p, its, conv = (t.numpy() for t in got)
    rp, rits, rconv = (np.asarray(a) for a in ref)
    assert p.shape == rp.shape == (len(KS), 2)
    np.testing.assert_array_equal(its, rits)
    np.testing.assert_array_equal(conv, rconv)
    assert conv.all()
    np.testing.assert_allclose(p, rp, rtol=0, atol=1e-9 * np.abs(rp).max())
    return p, its


OPTIONS = {
    "stream": dict(mg_transfers="stream"),
    "tp": dict(mg_transfers="tp"),
    "w_cycle": dict(mg_cycle_type="w"),
    "f_cycle": dict(mg_cycle_type="f"),
}


# the options that test_torch_mg_sweeps_stream.py runs
STREAMED = ["stream"]


@pytest.fixture(params=[o for o in OPTIONS if o not in STREAMED])
def option(request):
    return request.param


def test_sweep_option_matches_reference(sweeps, option):
    jnm, tnm = sweeps
    fn = jnm.sweep_fn(JaxKrylovConfig(**CONFIG), **KNOBS, **OPTIONS[option])
    with jax.disable_jit():
        ref = fn(jnm.params(), jnp.asarray(KS))
    got = tnm.sweep_fn(KrylovConfig(**CONFIG), **KNOBS, **OPTIONS[option])(tnm.params(), KS)
    p, its = _assert_matches(got, ref)
    if option in ("stream", "tp"):  # the gather sweep: the same operator
        gp, gits, _ = (t.numpy() for t in tnm.sweep_fn(KrylovConfig(**CONFIG), **KNOBS)(
            tnm.params(), KS))
        np.testing.assert_array_equal(its, gits)
        np.testing.assert_allclose(p, gp, rtol=0, atol=1e-10 * np.abs(gp).max())
