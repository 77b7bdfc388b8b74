"""On the cards: the sharded routes of slice 8 under NCCL, one rank per
card that torch sees (a world of one on a one-card host).

(a) NodeMajorRoomSweep.sharded_sweep_fn (box_hierarchy(6, 2), complex64,
the DIA kernel on every card) against the unsharded sweep of each rank's
chunk on the same card: every lane converged, equal iterations, pressures
within 1e-6 of max|p|, the kernel launched; (b) BemSolver with a
device_mesh (the 320-element sphere, complex64, Burton–Miller at ka 2 and
CBIE at ka 1, the BEM pairwise kernel on every card's row block) against
the unsharded GMRES solve: converged, within 1e-4, iterations within 2,
``sharded_over`` the world size. These tests need a CUDA device and skip
without one; they import no JAX (the parity with the reference is in
tests/test_torch_spmd*.py, tests/test_torch_fmm_spmd.py and
tests/test_torch_parallel*.py).

    python -m pytest tests/test_torch_parallel_cuda.py -m cuda -q
"""

import pytest
import torch

from _torch_parallel_ranks import cuda_rank
from mathaudio_tpu_torch.parallel.launch import launch

pytestmark = pytest.mark.cuda
INPUTS = dict(n=6, lanes=32, subdiv=2, sweep_cfg=dict(max_iterations=500, tolerance=1e-5,
                                                      restart=6),
              knobs=dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=2, gmres_orth="cgs1",
                         warm_stride=4, warm_restart=3, warm_interp="cubic"))


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs the sharded routes under NCCL)")
    from mathaudio_tpu_torch import kernels

    kernels.build_all(("dia_stencil", "bem_pairwise"))
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    return world, launch(cuda_rank, world, INPUTS, backend="nccl", join_timeout=180)


def test_sharded_sweep_on_the_cards(runs):
    world, out = runs
    first = out[0]["sweep"]
    for rank in range(world):
        got = out[rank]
        sweep = got["sweep"]
        assert got["dia_launches"] > 0
        assert bool(sweep["conv"].all()) and sweep["conv1"] and sweep["its_equal"]
        assert sweep["p_err"] <= 1e-6, sweep["p_err"]
        assert tuple(sweep["p"].shape) == (INPUTS["lanes"] * world, 2)
        assert torch.equal(sweep["p"], first["p"])  # every rank holds the whole band


@pytest.mark.parametrize("label", ["burton_miller", "cbie"])
def test_bem_device_mesh_on_the_cards(runs, label):
    world, out = runs
    for rank in range(world):
        got = out[rank][("bem", label)]
        assert got["launches"] > 0
        assert got["info"]["converged"] and got["info"]["sharded_over"] == world
        assert abs(got["info"]["iterations"] - got["ref_info"]["iterations"]) <= 2
        assert got["err"] <= 1e-4, got["err"]
