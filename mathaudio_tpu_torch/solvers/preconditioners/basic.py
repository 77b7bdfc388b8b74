"""Jacobi preconditioner (counterpart of
mathaudio_tpu/solvers/preconditioners/basic.py::jacobi_preconditioner)."""

from __future__ import annotations

import torch


class DiagonalOperator:
    """x -> d * x, with the ``matvec`` protocol the Krylov solvers take."""

    def __init__(self, d: torch.Tensor):
        self.d = d

    def matvec(self, x):
        return self.d * x

    __call__ = matvec


def jacobi_preconditioner(diag: torch.Tensor) -> DiagonalOperator:
    """M^{-1} = diag(A)^{-1}; zero diagonal entries pass through unchanged."""
    nonzero = torch.abs(diag) > 1e-300
    return DiagonalOperator(torch.where(nonzero, 1.0 / torch.where(nonzero, diag, 1.0), 1.0))
