"""The restart-and-budget case of test_torch_krylov_batched.py: lanes that
need more than one restart cycle, and one that spends its budget, solved by
the reference's ``gmres_batched`` and the port's, on that file's checks.
"""

import pytest

from test_torch_krylov_batched import (  # noqa: F401  (collected here)
    RESTARTS,
    test_matches_reference_lane_for_lane,
)


@pytest.fixture(params=RESTARTS)
def case(request):
    return request.param
