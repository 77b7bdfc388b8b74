"""Device-resident linear algebra: operators, sparse formats, Krylov
solvers, preconditioners (counterpart of mathaudio_tpu/solvers), with the
reference's re-exports in its order.
"""

from mathaudio_tpu_torch.solvers.operators import (  # noqa: F401
    LinearOperator,
    DenseOperator,
    DiagonalOperator,
    EllOperator,
    as_matvec,
)
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix, EllMatrix  # noqa: F401
from mathaudio_tpu_torch.solvers.krylov import (  # noqa: F401
    KrylovConfig,
    KrylovSolution,
    cg,
    bicgstab,
    cgs,
    qmrcgstab,
    gmres,
)
from mathaudio_tpu_torch.solvers.direct import lu_solve, complex_solve, LuFactorization  # noqa: F401
from mathaudio_tpu_torch.solvers.preconditioners import (  # noqa: F401
    identity_preconditioner,
    jacobi_preconditioner,
    IluColored,
    IluFixedPoint,
    BlockJacobi,
    AdditiveSchwarz,
    AmgConfig,
    AmgPreconditioner,
)
from mathaudio_tpu_torch.solvers import blas  # noqa: F401
