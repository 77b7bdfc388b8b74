"""The second half of test_torch_config_corpus_fem.py: its checks on the
three rectangular rooms that are not ``example_*`` (the two nearfield
stereo rooms and the small room).
"""

import pytest

from test_torch_config_corpus_fem import (  # noqa: F401  (collected here)
    FEM_CONFIGS,
    _one_torch_thread,
    fem_runs,
    test_frequencies_and_results,
    test_spl_matches_the_reference,
)

ROOMS = [p for p in FEM_CONFIGS if not p.stem.startswith("example_")]


@pytest.fixture(scope="module", params=ROOMS, ids=[p.stem for p in ROOMS])
def runs(request):
    return fem_runs(request.param)
