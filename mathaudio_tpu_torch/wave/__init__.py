"""Validation oracle: analytical wave/Helmholtz solutions and special
functions (counterpart of mathaudio_tpu/wave). Recurrences over orders
(Bessel, Legendre) are loops over orders, each step one elementwise pass
over the arguments.
"""

from mathaudio_tpu_torch.wave import special  # noqa: F401
from mathaudio_tpu_torch.wave import analytical  # noqa: F401
