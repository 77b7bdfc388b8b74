"""The 4-rank half of test_torch_spmd_sweep.py: the same checks against
the reference's shard_map over 4 virtual CPU devices, 4 wavenumbers a rank.
"""

import pytest

from test_torch_spmd_sweep import (  # noqa: F401  (collected here at 4 ranks)
    reference_sweep,
    run,
    test_sharded_sweep_matches_reference,
    test_sharded_sweep_rejects_indivisible,
)


@pytest.fixture(scope="module", params=[4], ids=["4ranks"])
def runs(request, reference_sweep):  # noqa: F811
    return run(request.param, reference_sweep)
