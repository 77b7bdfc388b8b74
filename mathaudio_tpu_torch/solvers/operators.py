"""Linear operators with a matvec protocol (counterpart of
mathaudio_tpu/solvers/operators.py).

The Krylov solvers take an operator object, a bare ``x -> Ax`` callable
or a 2-D tensor. The reference registers its operators as JAX pytrees so
they flow through jit; here they are plain objects holding tensors.
"""

from __future__ import annotations

from typing import Callable

import torch


class LinearOperator:
    """Protocol: subclasses implement matvec; optionally rmatvec/hmatvec."""

    def matvec(self, x):
        raise NotImplementedError

    def rmatvec(self, x):
        """A^T x."""
        raise NotImplementedError

    def hmatvec(self, x):
        """A^H x."""
        return torch.conj(self.rmatvec(torch.conj(x)))

    def __call__(self, x):
        return self.matvec(x)


def as_matvec(a) -> Callable:
    """Normalize operator-ish inputs (an object with ``matvec``, a
    callable, or a 2-D tensor) to an ``x -> Ax`` callable."""
    if hasattr(a, "matvec"):
        return a.matvec
    if callable(a):
        return a
    if isinstance(a, torch.Tensor) and a.dim() == 2:
        return lambda x: a @ x
    raise TypeError(f"cannot interpret {type(a)} as a linear operator")


class DenseOperator(LinearOperator):
    """Dense matrix operator."""

    def __init__(self, a):
        self.a = torch.as_tensor(a)

    def matvec(self, x):
        return self.a @ x

    def rmatvec(self, x):
        return self.a.T @ x

    def hmatvec(self, x):
        return torch.conj(self.a).T @ x


class DiagonalOperator(LinearOperator):
    def __init__(self, d):
        self.d = torch.as_tensor(d)

    def matvec(self, x):
        return self.d * x

    def rmatvec(self, x):
        return self.d * x

    def hmatvec(self, x):
        return torch.conj(self.d) * x


class EllOperator(LinearOperator):
    """Padded-row (ELLPACK) sparse operator.

    ``indices``/``values`` are (n, max_nnz_per_row); padding entries point
    at row 0 with value 0. The matvec is one gather and one row reduction,
    with no scatter: each output row reads its own slots.
    """

    def __init__(self, indices, values, num_cols=None):
        self.indices = torch.as_tensor(indices)
        self.values = torch.as_tensor(values)
        self.num_cols = int(num_cols) if num_cols is not None else self.indices.shape[0]

    def matvec(self, x):
        return torch.sum(self.values * x[self.indices], dim=1)

    def rmatvec(self, x):
        contrib = self.values * x[:, None]
        out = torch.zeros((self.num_cols,), dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, self.indices.reshape(-1), contrib.reshape(-1))
