"""PyTorch/CUDA port of mathaudio_tpu for NVIDIA Hopper.

Mirrors the subpackage layout of ``mathaudio_tpu`` (the JAX reference):
each module here has one counterpart there. This package imports torch
and numpy only; CUDA kernels are built from ``kernels/`` at first use, so
the package imports on a host without a GPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
``parallel/`` runs the sharded routes over several cards on
``torch.distributed``, one process and one card per rank.
"""

__version__ = "0.1.0"

from mathaudio_tpu_torch.xtypes import (  # noqa: F401
    default_float,
    default_complex,
    complex_dtype_for,
    SPEED_OF_SOUND,
    AIR_DENSITY,
    REFERENCE_PRESSURE,
)
