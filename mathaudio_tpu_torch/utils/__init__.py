"""Aux subsystems (counterpart of mathaudio_tpu/utils): wall-clock
profiling spans. The memory budgeting of the FEM apps (``utils/memory.py``)
comes with slice 6; the reference's ``utils/cache.py`` sets JAX's
compilation cache, whose counterpart here is the build directory the
kernels compile into at first use (``kernels/_build/``)."""

from mathaudio_tpu_torch.utils.profiling import span, Timer  # noqa: F401
