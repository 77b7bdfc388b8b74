"""ILU(0) with fixed-point triangular applies, and its graph-colored
variant (counterpart of mathaudio_tpu/solvers/preconditioners/ilu.py).

Factorization: IKJ ILU(0) on the host, on the CSR sparsity, by the C++
kernel of ``mathaudio_tpu_torch.native`` (built with g++ at first use; a
build failure raises); the greedy coloring of the colored variant by the
same library. The Python loops ``_ilu0_factor_python`` and
``_greedy_coloring_python`` are their plain twins, held against them by
the tests. Apply: Jacobi fixed-point sweeps on L and U, each sweep one ELL
matvec (a gather and a row reduction) on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from mathaudio_tpu_torch import native
from mathaudio_tpu_torch.solvers.operators import EllOperator, LinearOperator
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix
from mathaudio_tpu_torch.xtypes import complex_dtype_for, resolve_device, to_precision


def ilu0_factor(csr: CsrMatrix):
    """ILU(0): returns (L_csr strictly lower with unit diagonal implied,
    U_csr upper including the diagonal) on the input sparsity, by the
    native C++ kernel."""
    was_real = not np.iscomplexobj(csr.data)
    data = np.ascontiguousarray(csr.data, np.complex128).copy()
    native.ilu0_factor_inplace(csr.indptr, csr.indices, data)
    return _split_lu(csr, data.real.astype(csr.data.dtype) if was_real else data)


def _ilu0_factor_python(csr: CsrMatrix):
    """The reference's pure-Python IKJ loop: the plain twin of
    ``ilu0_factor``, for the tests (hours at room sizes)."""
    n = csr.shape[0]
    indptr, indices = csr.indptr, csr.indices
    data = csr.data.copy()
    col_pos = [dict() for _ in range(n)]
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            col_pos[i][int(indices[p])] = p
    for i in range(1, n):
        for p in range(indptr[i], indptr[i + 1]):
            k = int(indices[p])
            if k >= i:
                continue
            dk = col_pos[k].get(k)
            if dk is None or data[dk] == 0:
                continue
            data[p] = data[p] / data[dk]
            lik = data[p]
            for q in range(indptr[k], indptr[k + 1]):
                j = int(indices[q])
                if j <= k:
                    continue
                pij = col_pos[i].get(j)
                if pij is not None:
                    data[pij] -= lik * data[q]
    return _split_lu(csr, data)


def _split_lu(csr: CsrMatrix, data: np.ndarray):
    n = csr.shape[0]
    indptr, indices = csr.indptr, csr.indices
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    lower = indices < rows
    l_csr = CsrMatrix.from_triplets(
        rows[lower], indices[lower].astype(np.int64), data[lower], csr.shape
    )
    u_csr = CsrMatrix.from_triplets(
        rows[~lower], indices[~lower].astype(np.int64), data[~lower], csr.shape
    )
    return l_csr, u_csr


class IluFixedPoint(LinearOperator):
    """M^{-1} r by fixed-point sweeps:  L z = r  then  U x = z.

    z <- r - L_strict z   (unit lower)
    x <- D^{-1}(z - U_strict x)
    """

    def __init__(self, l_op: EllOperator, u_strict_op: EllOperator, u_diag_inv, sweeps: int = 6):
        self.l_op = l_op
        self.u_strict_op = u_strict_op
        self.u_diag_inv = u_diag_inv
        self.sweeps = int(sweeps)

    @classmethod
    def from_csr(cls, csr: CsrMatrix, sweeps: int = 6, *, device=None):
        """Factor ``csr`` on the host (in complex128) and put the factors on
        ``device`` (default ``cuda``; raises without a GPU) in the precision
        of the CSR's values."""
        device = resolve_device(device)
        l_csr, u_csr = ilu0_factor(csr)
        diag = u_csr.diagonal()
        rows = np.repeat(np.arange(u_csr.shape[0]), np.diff(u_csr.indptr))
        mask = rows != u_csr.indices
        u_strict = CsrMatrix.from_triplets(
            rows[mask], u_csr.indices[mask], u_csr.data[mask], u_csr.shape
        )
        l_ell = l_csr.to_ell().operator(device=device)
        u_ell = u_strict.to_ell().operator(device=device)
        safe = np.where(np.abs(diag) > 1e-300, diag, 1.0)
        pre = cls(l_ell, u_ell, torch.as_tensor(1.0 / safe, device=device), sweeps)
        want = torch.as_tensor(csr.data[:0]).dtype
        return pre.to(want if want.is_complex else complex_dtype_for(want))

    def matvec(self, r):
        z = r
        for _ in range(self.sweeps):
            z = r - self.l_op.matvec(z)
        x = self.u_diag_inv * z
        for _ in range(self.sweeps):
            x = self.u_diag_inv * (z - self.u_strict_op.matvec(x))
        return x

    def to(self, dtype=None, device=None) -> "IluFixedPoint":
        """A copy at the precision of the complex ``dtype`` on ``device``
        (see ``xtypes.to_precision``)."""
        def ell(op):
            return EllOperator(op.indices.to(device=device),
                               to_precision(op.values, dtype, device), op.num_cols)

        return IluFixedPoint(ell(self.l_op), ell(self.u_strict_op),
                             to_precision(self.u_diag_inv, dtype, device), self.sweeps)


def _symmetric_graph(csr: CsrMatrix):
    """The symmetrized sparsity graph of ``csr`` (scipy CSR, int8 ones)."""
    import scipy.sparse as sp

    a = sp.csr_matrix(
        (np.ones_like(csr.data, dtype=np.int8), csr.indices, csr.indptr), shape=csr.shape
    )
    return (a + a.T).tocsr()


def greedy_coloring(csr: CsrMatrix) -> np.ndarray:
    """Greedy multicoloring of the symmetrized sparsity graph, by the
    native C++ kernel: adjacent rows get different colors, so within a
    color the triangular factors have no couplings. int32 (N,)."""
    s = _symmetric_graph(csr)
    return native.greedy_coloring(s.indptr, s.indices)


def _greedy_coloring_python(csr: CsrMatrix) -> np.ndarray:
    """The reference's Python loop: the plain twin of ``greedy_coloring``."""
    s = _symmetric_graph(csr)
    colors = np.full(csr.shape[0], -1, np.int32)
    for i in range(csr.shape[0]):
        nbr = s.indices[s.indptr[i]: s.indptr[i + 1]]
        used = set(colors[nbr[colors[nbr] >= 0]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


class IluColored(LinearOperator):
    """Graph-coloring ILU(0): rows permuted by color make the strictly
    triangular factors nilpotent of degree n_colors, so n_colors Jacobi
    sweeps solve L and U exactly, each sweep one ELL matvec. An apply is
    2 n_colors sweeps (each color one group of launches on the card) and
    the two permutation gathers."""

    def __init__(self, inner: IluFixedPoint, perm, inv_perm):
        self.inner = inner
        self.perm = perm
        self.inv_perm = inv_perm

    @classmethod
    def from_csr(cls, csr: CsrMatrix, *, device=None):
        """Color, permute and factor ``csr`` on the host; the factors go to
        ``device`` (default ``cuda``) as ``IluFixedPoint.from_csr`` puts
        them."""
        import scipy.sparse as sp

        device = resolve_device(device)
        colors = greedy_coloring(csr)
        n_colors = int(colors.max()) + 1
        perm = np.argsort(colors, kind="stable")
        a = sp.csr_matrix((csr.data, csr.indices, csr.indptr), shape=csr.shape)
        ap = a[perm][:, perm].tocsr()
        ap.sort_indices()
        csr_p = CsrMatrix(
            ap.indptr.astype(np.int64), ap.indices.astype(np.int64), ap.data, csr.shape
        )
        inner = IluFixedPoint.from_csr(csr_p, sweeps=n_colors, device=device)
        inv_perm = np.argsort(perm)
        return cls(inner, torch.as_tensor(perm, device=device),
                   torch.as_tensor(inv_perm, device=device))

    @property
    def n_colors(self) -> int:
        return self.inner.sweeps

    def matvec(self, r):
        return self.inner.matvec(r[self.perm])[self.inv_perm]
