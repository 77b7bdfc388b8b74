"""The 4-rank half of test_torch_spmd.py: the same checks on its
reference at 4 virtual CPU devices and 4 gloo ranks (50 rows over 4 shards
leave the last with padding rows; so does the 30 x 30 dense matrix).
"""

import pytest

from test_torch_spmd import (  # noqa: F401  (collected here at 4 ranks)
    run,
    test_matvec_rank_by_rank,
    test_allgather_matvec_is_the_halo_matvec,
    test_sharded_gmres,
    test_dense_rowblock_solve,
    test_solver_with_axis_name,
    test_bem_solver_device_mesh,
)


@pytest.fixture(scope="module", params=[4], ids=["4ranks"])
def runs(request):
    return run(request.param)
