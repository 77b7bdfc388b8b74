"""Identity and Jacobi preconditioners (counterpart of
mathaudio_tpu/solvers/preconditioners/basic.py)."""

from __future__ import annotations

import torch

from mathaudio_tpu_torch.solvers.operators import DiagonalOperator, LinearOperator


def identity_preconditioner() -> LinearOperator:
    class _Identity(LinearOperator):
        def matvec(self, x):
            return x

        def rmatvec(self, x):
            return x

    return _Identity()


def jacobi_preconditioner(diag: torch.Tensor) -> DiagonalOperator:
    """M^{-1} = diag(A)^{-1}; zero diagonal entries pass through unchanged."""
    nonzero = torch.abs(diag) > 1e-300
    return DiagonalOperator(torch.where(nonzero, 1.0 / torch.where(nonzero, diag, 1.0), 1.0))
