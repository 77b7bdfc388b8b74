"""Preconditioners (counterpart of mathaudio_tpu/solvers/preconditioners):
identity and Jacobi; ILU(0) factored on the host by the native C++ kernel
with fixed-point triangular applies on the device, and its graph-colored
variant (exact sweeps color by color); additive Schwarz and block Jacobi
(one batched inverse of the padded blocks); algebraic multigrid (host
set-up, V-cycle on the device).
"""

from mathaudio_tpu_torch.solvers.preconditioners.basic import (  # noqa: F401
    identity_preconditioner,
    jacobi_preconditioner,
)
from mathaudio_tpu_torch.solvers.preconditioners.ilu import (  # noqa: F401
    IluColored,
    IluFixedPoint,
    greedy_coloring,
    ilu0_factor,
)
from mathaudio_tpu_torch.solvers.preconditioners.schwarz import (  # noqa: F401
    AdditiveSchwarz,
    BlockJacobi,
)
from mathaudio_tpu_torch.solvers.preconditioners.amg import AmgConfig, AmgPreconditioner  # noqa: F401
