"""PyTorch/CUDA port of mathaudio_tpu for NVIDIA Hopper.

Mirrors the subpackage layout of ``mathaudio_tpu`` (the JAX reference):
each module here has one counterpart there. This package imports torch
and numpy only; CUDA kernels are built from ``kernels/`` at first use, so
the package imports on a host without a GPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
