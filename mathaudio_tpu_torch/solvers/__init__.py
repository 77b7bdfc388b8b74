"""Device-resident linear algebra: operators, sparse formats, Krylov
solvers, preconditioners (counterpart of mathaudio_tpu/solvers).

Re-exports the reference's names that are ported; CG, BiCGStab, CGS,
QMRCGStab, ``LuFactorization``, ``blas`` and the colored ILU, Schwarz and
AMG preconditioners come with slice 6b of the port.
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
    gmres,
)
from mathaudio_tpu_torch.solvers.direct import lu_solve, complex_solve  # noqa: F401
from mathaudio_tpu_torch.solvers.preconditioners import (  # noqa: F401
    identity_preconditioner,
    jacobi_preconditioner,
    IluFixedPoint,
)
