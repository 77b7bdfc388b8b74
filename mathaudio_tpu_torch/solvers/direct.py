"""Dense direct solve (counterpart of mathaudio_tpu/solvers/direct.py
``complex_solve`` and ``lu_solve``, native path).

The reference embeds a complex system in a real 2N x 2N one on the TPU,
which has no complex LU (its ``method="embed"``, and any value but "auto"
and "native"); on the GPU and the CPU the native complex LU is used for
every ``method``, batched over any leading dimensions.
"""

from __future__ import annotations

import torch


def complex_solve(a, b, method: str = "auto"):
    """Solve A x = b for (..., N, N) A and (..., N) or (..., N, K) b.

    ``method`` is accepted as the reference accepts it, any value, and
    every value runs the native LU (the reference's real embedding, which
    it runs for "embed" and any value it does not name, is its way around
    a TPU without a complex LU, and solves the same system)."""
    del method
    return torch.linalg.solve(a, b)


def lu_solve(a, b, method: str = "auto"):
    """One-shot dense solve of A x = b."""
    return complex_solve(a, b, method=method)
