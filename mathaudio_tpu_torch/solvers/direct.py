"""Dense direct solve (counterpart of mathaudio_tpu/solvers/direct.py
``complex_solve`` and ``lu_solve``, native path).

The reference embeds a complex system in a real 2N x 2N one on the TPU;
on the GPU (and the CPU) the native complex LU is used, batched over any
leading dimensions.
"""

from __future__ import annotations

import torch


def complex_solve(a, b):
    """Solve A x = b for (..., N, N) A and (..., N) or (..., N, K) b."""
    return torch.linalg.solve(a, b)


def lu_solve(a, b):
    """One-shot dense solve of A x = b."""
    return complex_solve(a, b)
