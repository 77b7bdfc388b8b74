"""Port vs reference: the rectangular files of ``configs/`` other than
``home_theater_*`` through the two roomsim_fem CLIs
(``run_fem_simulation(cfg, verbose=0)``): the two ``example_*`` rooms here,
the other three in test_torch_config_corpus_fem_rooms.py (a file of its
own, so that a parallel test run takes the two at once).

Each config is clamped as tests/test_config_corpus.py clamps it for its FEM
smoke (tests/_torch_corpus.py): 2 frequencies up to 120 Hz, mesh resolution
2, absorption 0.1 on all-rigid rooms. The port runs on the CPU in float64.
Per config: the same frequencies and number of results, both converged,
and SPL within 1e-6 dB at every frequency and listening position (measured
<= 4.3e-14 dB on one host; the margin covers another host's BLAS order).
The three ``home_theater_*`` rooms cost ~10 s a side each and add no path
the others miss.
"""

import numpy as np
import pytest
import torch

import mathaudio_tpu.apps.roomsim_fem as jax_roomsim
import mathaudio_tpu.common.config as jax_config
import mathaudio_tpu_torch.apps.roomsim_fem as roomsim
import mathaudio_tpu_torch.common.config as config
from _torch_corpus import CONFIGS, SPL_TOL_DB, smoke_clamp, spl_matrix

FEM_CONFIGS = [p for p in CONFIGS
               if config.RoomConfig.from_file(str(p)).room.get("type") == "rectangular"
               and not p.stem.startswith("home_theater_")]
FEM_RESOLUTION = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def fem_runs(path):
    """(port results, reference results, the port's config) of one file."""
    path = str(path)
    cfg = smoke_clamp(config.RoomConfig.from_file(path), FEM_RESOLUTION, config.SurfaceSpec)
    ref_cfg = smoke_clamp(jax_config.RoomConfig.from_file(path), FEM_RESOLUTION,
                          jax_config.SurfaceSpec)
    assert cfg.to_dict() == ref_cfg.to_dict()
    got = roomsim.run_fem_simulation(cfg, verbose=0, device="cpu", dtype=torch.float64)
    ref = jax_roomsim.run_fem_simulation(ref_cfg, verbose=0)
    return got, ref, cfg


EXAMPLES = [p for p in FEM_CONFIGS if p.stem.startswith("example_")]


@pytest.fixture(scope="module", params=EXAMPLES, ids=[p.stem for p in EXAMPLES])
def runs(request):
    return fem_runs(request.param)


def test_the_fem_corpus_is_the_five_rectangular_rooms():
    assert [p.stem for p in FEM_CONFIGS] == ["example_multi_source", "example_rectangular",
                                             "nearfield_stereo", "nearfield_stereo_vis",
                                             "small_room"]


def test_frequencies_and_results(runs):
    got, ref, _ = runs
    assert len(got.results) == len(ref.results) == 2
    assert [r.frequency for r in got.results] == [r.frequency for r in ref.results]
    assert all(r.converged for r in got.results) and all(r.converged for r in ref.results)


def test_spl_matches_the_reference(runs):
    got, ref, cfg = runs
    spl, ref_spl = spl_matrix(got), spl_matrix(ref)
    assert spl.shape == ref_spl.shape == (2, len(cfg.listening_positions))
    assert np.isfinite(spl).all()
    assert np.abs(spl - ref_spl).max() <= SPL_TOL_DB, np.abs(spl - ref_spl).max()
