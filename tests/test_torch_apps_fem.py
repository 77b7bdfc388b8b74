"""Port vs reference: the FEM room simulator (apps/roomsim_fem.py) and the
memory budgeting it uses (utils/memory.py), on the CPU in float64.

roomsim_fem runs the reference tests' tiny room (tests/test_common_apps.py)
flat (batches of 2, the last one padded, with a spatial slice) and
hierarchically: the SPL agrees within 1e-9 dB, iterations and converged
flags are equal lane for lane; the CLI writes the same results with its
automatic batch. The QA FEM suite's case is in tests/test_torch_qa_fem.py
(each reference build compiles for its own shapes, so the two share no
compile and stay under a minute apart).
"""

import json

import numpy as np
import pytest
import torch

from mathaudio_tpu.apps import roomsim_fem as jax_roomsim
from mathaudio_tpu.common.config import RoomConfig as JaxRoomConfig
from mathaudio_tpu.utils import memory as jax_memory
from mathaudio_tpu_torch.apps import roomsim_fem
from mathaudio_tpu_torch.common.config import RoomConfig
from mathaudio_tpu_torch.utils import memory

CPU64 = dict(dtype=torch.float64, device="cpu")
TINY = {
    "room": {"type": "rectangular", "width": 2.0, "depth": 2.0, "height": 2.0},
    "sources": [{"name": "s", "position": {"x": 0.5, "y": 0.5, "z": 1.0}}],
    "listening_positions": [{"x": 1.2, "y": 1.4, "z": 1.0}],
    "frequencies": {"min_freq": 50.0, "max_freq": 90.0, "num_points": 3},
    "boundaries": {"walls": {"type": "absorption", "coefficient": 0.2}},
    "solver": {"mesh_resolution": 4, "gmres": {"tolerance": 1e-6}},
    "visualization": {"generate_slices": True, "slice_resolution": 8},
}
# run: (simulation keywords, run keywords)
RUNS = {"flat": (dict(batch_size=2), {}), "hierarchical": ({}, dict(hierarchical=True))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference():
    """{run: (the reference's FemRoomSimulation, its results)}."""
    out = {}
    for name, (sim_kw, run_kw) in RUNS.items():
        sim = jax_roomsim.FemRoomSimulation(JaxRoomConfig.from_dict(TINY), verbose=0, **sim_kw)
        out[name] = (sim, sim.run(**run_kw))
    return out


def _same_results(got, want):
    assert len(got) == len(want) == TINY["frequencies"]["num_points"]
    for g, w in zip(got, want):
        assert g.frequency == w.frequency
        np.testing.assert_allclose(g.spl_db, w.spl_db, rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.array(g.pressure_real) + 1j * np.array(g.pressure_imag),
                                   np.array(w.pressure_real) + 1j * np.array(w.pressure_imag),
                                   rtol=1e-10)
        assert (g.iterations, g.converged) == (w.iterations, w.converged)
        assert g.converged and g.iterations > 0


@pytest.mark.parametrize("run", list(RUNS))
def test_roomsim_fem_matches_reference(reference, run):
    ref = reference[run][1]
    sim_kw, run_kw = RUNS[run]
    got = roomsim_fem.run_fem_simulation(RoomConfig.from_dict(TINY), verbose=0, **sim_kw, **run_kw,
                                         **CPU64)
    _same_results(got.results, ref.results)
    for key in ("engine", "num_nodes", "iterations", "converged", "hierarchical", "num_elements"):
        assert got.metadata.get(key) == ref.metadata.get(key), key
    assert len(got.slices) == len(ref.slices) == (1 if run == "flat" else 0)
    for g, w in zip(got.slices, ref.slices):
        assert g["frequency"] == w["frequency"] and g["x"] == w["x"] and g["z"] == w["z"]
        np.testing.assert_allclose(g["spl_db"], w["spl_db"], rtol=0, atol=1e-9)


def test_roomsim_fem_cli_writes_the_reference_results(reference, tmp_path):
    cfg = tmp_path / "tiny.json"
    RoomConfig.from_dict(TINY).to_file(str(cfg))
    out = tmp_path / "out.json"
    assert roomsim_fem.main([str(cfg), "--cpu", "-o", str(out), "-v", "0"]) == 0
    with open(out) as fh:
        res = json.load(fh)
    assert res["metadata"]["engine"] == "fem"
    ref = reference["flat"][1].results
    for r, w in zip(res["results"], ref):
        np.testing.assert_allclose(r["spl_db"], w.spl_db, rtol=0, atol=1e-9)
        assert (r["iterations"], r["converged"]) == (w.iterations, w.converged)


def test_roomsim_fem_mesh_and_sources_match_reference(reference):
    """The box hierarchy's fine mesh, the nearest-node listening indices, the
    Gaussian source vectors and the per-wall Robin coefficients."""
    ref = reference["flat"][0]
    got = roomsim_fem.FemRoomSimulation(RoomConfig.from_dict(TINY), verbose=0, **CPU64)
    np.testing.assert_array_equal(got.mesh.nodes, ref.mesh.nodes)
    np.testing.assert_array_equal(got.listen_idx.numpy(), np.asarray(ref.listen_idx))
    np.testing.assert_allclose(got.rhs_stack.numpy(), np.asarray(ref.rhs_stack), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(ref.rhs_stack)).max())
    k = 1.3
    np.testing.assert_allclose(got._robin_coeffs([k])[:, 0].numpy(),
                               np.asarray(ref._robin_coeffs(k)), rtol=1e-14)
    np.testing.assert_array_equal(got.source_weights([50.0, 70.0]),
                                  ref.source_weights([50.0, 70.0]))
    assert roomsim_fem._mesh_dims(2.0, 2.5, 3.1, 4, 4) == jax_roomsim._mesh_dims(2.0, 2.5, 3.1, 4, 4)


@pytest.mark.parametrize("args", [(30525, 460000, 300, 3), (1053, 14000, 30, 3), (500, 3000, 8, 1),
                                  (10**7, 10**8, 300, 3)])
def test_memory_budget_matches_reference(args):
    est, ref = memory.MemoryEstimate(*args), jax_memory.MemoryEstimate(*args)
    assert est.per_frequency_bytes() == ref.per_frequency_bytes()
    for budget in (2**30, 8 * 2**30, 80 * 2**30):
        assert est.batch_size(budget) == ref.batch_size(budget)
        assert memory.hbm_frequency_batch(*args, budget_bytes=budget) == \
            jax_memory.hbm_frequency_batch(*args, budget_bytes=budget)
    assert memory.hbm_frequency_batch(*args) == jax_memory.hbm_frequency_batch(*args)
