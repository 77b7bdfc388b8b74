"""The cubic warm start of test_torch_room_sweep_nm.py: the node-major
sweep warm-started with stride 4 and cubic anchor interpolation against the
reference's, on that file's builds and checks (the linear one is in
test_torch_room_sweep_nm_warm_linear.py: each eager reference takes 10-85 s
in a parallel test run).
"""

import pytest

from test_torch_room_sweep_nm import (  # noqa: F401  (collected here, cubic)
    CUBIC,
    sweeps,
    test_sweep_matches_reference,
)


@pytest.fixture(params=CUBIC)
def variant(request):
    return request.param
