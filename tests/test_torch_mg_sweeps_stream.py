"""The streamed-transfer case of test_torch_mg_sweeps.py: the node-major
sweep with ``mg_transfers="stream"`` against the reference's, and against
the port's gather sweep (the same operator), on that file's builds and
checks.
"""

import pytest

from test_torch_mg_sweeps import (  # noqa: F401  (collected here, streamed)
    STREAMED,
    sweeps,
    test_sweep_option_matches_reference,
)


@pytest.fixture(params=STREAMED)
def option(request):
    return request.param
