"""Preconditioners (counterpart of mathaudio_tpu/solvers/preconditioners):
identity and Jacobi, and ILU(0) factored on the host by the native C++
kernel with fixed-point triangular applies on the device. The colored
ILU, the Schwarz family and AMG come with slice 6b of the port.
"""

from mathaudio_tpu_torch.solvers.preconditioners.basic import (  # noqa: F401
    identity_preconditioner,
    jacobi_preconditioner,
)
from mathaudio_tpu_torch.solvers.preconditioners.ilu import (  # noqa: F401
    IluFixedPoint,
    ilu0_factor,
)
