"""Host-side CSR construction (counterpart of the CSR part of
mathaudio_tpu/solvers/sparse.py). Sparsity is built once with numpy;
device code only ever sees value vectors and slot maps."""

from __future__ import annotations

import dataclasses

import numpy as np


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
