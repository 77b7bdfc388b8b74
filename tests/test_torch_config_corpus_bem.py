"""Port vs reference: every file of ``configs/`` through the two roomsim_bem
CLIs (``run_bem_simulation(cfg, verbose=0, solver="gmres")``).

Each config is clamped as tests/test_config_corpus.py clamps it for its BEM
smoke (tests/_torch_corpus.py): 2 frequencies up to 120 Hz, mesh resolution
1 (2 under 20 m^3), absorption 0.1 on all-rigid rooms. The port runs on
the CPU in float64. Per config: the same frequencies and number of results,
SPL within 1e-6 dB at every frequency and listening position (measured
<= 5.7e-14 dB on one host; the margin covers another host's BLAS order),
and the same keys in the two JSON outputs (``common/output.py``
``create_output_json``), metadata and per-frequency results included.
"""

import numpy as np
import pytest
import torch

import mathaudio_tpu.apps.roomsim_bem as jax_roomsim
import mathaudio_tpu.common.config as jax_config
import mathaudio_tpu_torch.apps.roomsim_bem as roomsim
import mathaudio_tpu_torch.common.config as config
from _torch_corpus import CONFIGS, SPL_TOL_DB, bem_clamp, key_paths, spl_matrix

NAMES = [p.stem for p in CONFIGS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=CONFIGS, ids=NAMES)
def runs(request):
    """(port results, reference results, the port's config) of one file."""
    path = str(request.param)
    cfg = bem_clamp(config.RoomConfig.from_file(path), config.SurfaceSpec)
    ref_cfg = bem_clamp(jax_config.RoomConfig.from_file(path), jax_config.SurfaceSpec)
    assert cfg.to_dict() == ref_cfg.to_dict()
    got = roomsim.run_bem_simulation(cfg, verbose=0, solver="gmres", device="cpu",
                                     dtype=torch.float64)
    ref = jax_roomsim.run_bem_simulation(ref_cfg, verbose=0, solver="gmres")
    return got, ref, cfg


def test_the_corpus_is_whole():
    assert len(CONFIGS) == 10 and "small_room" in NAMES and "home_theater_5_1_4" in NAMES


def test_frequencies_and_results(runs):
    got, ref, cfg = runs
    assert len(got.results) == len(ref.results) == 2
    assert [r.frequency for r in got.results] == [r.frequency for r in ref.results]
    assert got.metadata["num_elements"] == ref.metadata["num_elements"]
    assert [r.converged for r in got.results] == [r.converged for r in ref.results]


def test_spl_matches_the_reference(runs):
    got, ref, cfg = runs
    spl, ref_spl = spl_matrix(got), spl_matrix(ref)
    assert spl.shape == ref_spl.shape == (2, len(cfg.listening_positions))
    assert np.isfinite(spl).all()
    assert np.abs(spl - ref_spl).max() <= SPL_TOL_DB, np.abs(spl - ref_spl).max()


def test_json_keys_match_the_reference(runs):
    got, ref, _ = runs
    assert key_paths(got.to_dict()) == key_paths(ref.to_dict())
