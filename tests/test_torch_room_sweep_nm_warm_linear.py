"""The linear warm start of test_torch_room_sweep_nm.py: the node-major
sweep warm-started with stride 4 and linear anchor interpolation against
the reference's, on that file's builds and checks.
"""

import pytest

from test_torch_room_sweep_nm import (  # noqa: F401  (collected here, linear)
    LINEAR,
    sweeps,
    test_sweep_matches_reference,
)


@pytest.fixture(params=LINEAR)
def variant(request):
    return request.param
