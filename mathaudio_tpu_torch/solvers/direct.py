"""Dense direct solve and reusable LU factors (counterpart of
mathaudio_tpu/solvers/direct.py, native path).

The reference embeds a complex system in a real 2N x 2N one on the TPU,
which has no complex LU (its ``method="embed"``, and any value but "auto"
and "native"); on the GPU and the CPU the native complex LU is used for
every ``method``, batched over any leading dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

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


class LuFactorization(NamedTuple):
    """Reusable LU factors of a square matrix (``torch.linalg.lu_factor``).

    The reference stores the real-embedded 2N x 2N factors when asked to
    ``embed`` (its TPU path); here every ``method`` factors the matrix in
    its own dtype, complex included, so ``embedded`` is always False."""

    lu: torch.Tensor
    piv: torch.Tensor
    embedded: bool
    n: int

    @classmethod
    def factor(cls, a, method: str = "auto"):
        del method  # every method runs the native LU (module notes)
        lu, piv = torch.linalg.lu_factor(a)
        return cls(lu, piv, False, a.shape[0])

    def solve(self, b):
        """x with A x = b for (N,) or (N, K) b."""
        vec = b.dim() == 1
        x = torch.linalg.lu_solve(self.lu, self.piv, b[:, None] if vec else b)
        return x[:, 0] if vec else x
