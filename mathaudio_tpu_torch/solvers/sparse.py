"""Sparse matrix containers (counterpart of mathaudio_tpu/solvers/sparse.py):
CSR on the host (construction and analysis, numpy), ELL on the device
(execution). Sparsity is built once with numpy; device code only ever sees
padded index/value tables and slot maps."""

from __future__ import annotations

import dataclasses

from typing import Optional

import numpy as np
import torch

from mathaudio_tpu_torch.solvers.operators import EllOperator
from mathaudio_tpu_torch.xtypes import resolve_device


@dataclasses.dataclass
class CsrMatrix:
    """Host-side CSR (numpy). Rows: indptr (n+1,), indices (nnz,), data (nnz,)."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple

    @classmethod
    def from_triplets(cls, rows, cols, vals, shape):
        """Build from COO triplets, summing duplicates."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        n_rows, _ = shape
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if len(rows) == 0:
            return cls(np.zeros(n_rows + 1, np.int64), cols, vals, shape)
        new_group = np.ones(len(rows), bool)
        new_group[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        group_id = np.cumsum(new_group) - 1
        n_groups = group_id[-1] + 1
        out_vals = np.zeros(n_groups, vals.dtype)
        np.add.at(out_vals, group_id, vals)
        out_rows = rows[new_group]
        out_cols = cols[new_group]
        indptr = np.zeros(n_rows + 1, np.int64)
        np.add.at(indptr, out_rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr, out_cols.astype(np.int32), out_vals, shape)

    @property
    def nnz(self) -> int:
        return len(self.data)

    @classmethod
    def from_dense(cls, a):
        a = np.asarray(a)
        rows, cols = np.nonzero(a)
        return cls.from_triplets(rows, cols, a[rows, cols], a.shape)

    def _rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, self.data.dtype)
        np.add.at(out, (self._rows(), self.indices), self.data)
        return out

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape), self.data.dtype)
        rows = self._rows()
        hit = rows == self.indices
        np.add.at(d, rows[hit], self.data[hit])
        return d

    def matvec(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        out = np.zeros(self.shape[0], np.result_type(self.data, x))
        np.add.at(out, self._rows(), self.data * x[self.indices])
        return out

    def max_row_nnz(self) -> int:
        return int(np.max(np.diff(self.indptr))) if self.shape[0] else 0

    def _ell_slots(self, pad_to_multiple: int = 1):
        """Vectorized (width, rows, offsets) for the padded layout."""
        width = self.max_row_nnz()
        if pad_to_multiple > 1:
            width = -(-width // pad_to_multiple) * pad_to_multiple
        counts = np.diff(self.indptr)
        rows = np.repeat(np.arange(self.shape[0]), counts)
        offsets = np.arange(self.nnz) - np.repeat(self.indptr[:-1], counts)
        return width, rows, offsets

    def to_ell(self, max_nnz: Optional[int] = None, pad_to_multiple: int = 1) -> "EllMatrix":
        """Convert to the padded layout (host arrays; ``EllMatrix.operator``
        moves it to a device). ``pad_to_multiple`` rounds the row width up."""
        width, rows, offsets = self._ell_slots(pad_to_multiple)
        if max_nnz is not None:
            width = max(width, max_nnz)
        n = self.shape[0]
        idx = np.zeros((n, width), np.int32)
        val = np.zeros((n, width), self.data.dtype)
        idx[rows, offsets] = self.indices
        val[rows, offsets] = self.data
        return EllMatrix(idx, val, self.shape)

    def ell_structure(self, pad_to_multiple: int = 1):
        """Return (ell_indices, scatter_map) for value-only refresh:
        ``scatter_map`` maps each CSR nnz slot to its flat ELL slot, so a
        new data vector with the same sparsity becomes new ELL values via
        one scatter."""
        width, rows, offsets = self._ell_slots(pad_to_multiple)
        n = self.shape[0]
        idx = np.zeros((n, width), np.int32)
        idx[rows, offsets] = self.indices
        scatter = rows.astype(np.int64) * width + offsets
        return idx, scatter


@dataclasses.dataclass
class EllMatrix:
    """Padded sparse matrix on the host; ``operator`` puts it on a device
    (see EllOperator)."""

    indices: np.ndarray  # (n, width) int32
    values: np.ndarray  # (n, width)
    shape: tuple

    def operator(self, *, device=None) -> EllOperator:
        """The matrix as an EllOperator on ``device`` (default ``cuda``;
        raises without a GPU)."""
        device = resolve_device(device)
        return EllOperator(torch.as_tensor(self.indices, dtype=torch.int64, device=device),
                           torch.as_tensor(self.values, device=device), self.shape[1])

    def matvec(self, x):
        """A x on the device of ``x``."""
        x = torch.as_tensor(x)
        return self.operator(device=x.device).matvec(x)
