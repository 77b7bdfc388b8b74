"""Aux subsystems (counterpart of mathaudio_tpu/utils): wall-clock
profiling spans and the memory budgeting of the FEM apps
(``utils/memory.py``). The reference's ``utils/cache.py`` sets JAX's
compilation cache, whose counterpart here is the build directory the
kernels compile into at first use (``kernels/_build/``)."""

from mathaudio_tpu_torch.utils.profiling import span, Timer  # noqa: F401
from mathaudio_tpu_torch.utils.memory import MemoryEstimate, hbm_frequency_batch  # noqa: F401
