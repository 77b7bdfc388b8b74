"""Additive Schwarz and block-Jacobi preconditioners (counterpart of
mathaudio_tpu/solvers/preconditioners/schwarz.py).

The reference's algorithm: a contiguous partition, extended by adjacency
layers for the overlap, dense subdomain blocks taken from CSR rows on the
host, 1/count weights on the overlap. The blocks are padded to one size
(identity in the padding) and inverted in one batched ``torch.linalg.inv``
on the device, so an apply is one gather, one batched matrix-vector
product and one ``index_add_``.
"""

from __future__ import annotations

import numpy as np
import torch

from mathaudio_tpu_torch.solvers.operators import LinearOperator
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix
from mathaudio_tpu_torch.xtypes import full_f32_matmul, real_dtype_for, resolve_device


def _extend_partition(part, indptr, indices, overlap, n):
    current = set(part)
    frontier = set(part)
    for _ in range(overlap):
        new = set()
        for i in frontier:
            new.update(int(j) for j in indices[indptr[i]: indptr[i + 1]])
        frontier = new - current
        current |= frontier
        if not frontier:
            break
    return sorted(current)


def csr_diag_blocks(csr: CsrMatrix, parts, bs: int) -> np.ndarray:
    """(k, bs, bs) dense subdomain blocks A[idx, idx] taken from the CSR
    rows of each part, never densifying the global matrix. Padded slots
    (beyond each part's length) carry the identity, so the batched inverse
    stays well-posed."""
    k = len(parts)
    blocks = np.tile(np.eye(bs, dtype=csr.data.dtype), (k, 1, 1))
    n = csr.shape[0]
    pos = np.full(n, -1, np.int64)
    indptr = csr.indptr.astype(np.int64)
    for bi, p in enumerate(parts):
        idx = np.asarray(p, np.int64)
        m = len(idx)
        if m == 0:
            continue
        pos[idx] = np.arange(m)
        blocks[bi, :m, :m] = 0.0
        counts = indptr[idx + 1] - indptr[idx]
        total = int(counts.sum())
        if total:
            # flat CSR slots of every entry in the part's rows
            flat = np.repeat(indptr[idx], counts) + (
                np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
            )
            cols = csr.indices[flat]
            keep = pos[cols] >= 0  # columns inside the subdomain
            rloc = np.repeat(np.arange(m), counts)[keep]
            np.add.at(blocks[bi], (rloc, pos[cols[keep]]), csr.data[flat][keep])
        pos[idx] = -1
    return blocks


class AdditiveSchwarz(LinearOperator):
    """Overlapping-subdomain additive Schwarz with batched dense solves."""

    def __init__(self, gather_idx, inv_blocks, weights, valid_mask):
        self.gather_idx = gather_idx  # (k, bs) int64 global index per slot
        self.inv_blocks = inv_blocks  # (k, bs, bs) explicit block inverses
        self.weights = weights  # (n,) 1/overlap-count
        self.valid_mask = valid_mask  # (k, bs) 1.0 where the slot is a real DoF

    @classmethod
    def from_csr(cls, csr: CsrMatrix, num_subdomains: int, overlap: int = 1, *, device=None):
        """Partition, extend and gather the blocks on the host, then invert
        them on ``device`` (default ``cuda``) in the CSR values' dtype; in
        float32 the inverse runs in true float32 (no TF32)."""
        device = resolve_device(device)
        n = csr.shape[0]
        k = max(1, min(num_subdomains, n))
        base, rem = divmod(n, k)
        parts = []
        start = 0
        for i in range(k):
            size = base + (1 if i < rem else 0)
            parts.append(list(range(start, start + size)))
            start += size
        parts = [_extend_partition(p, csr.indptr, csr.indices, overlap, n) for p in parts]

        counts = np.zeros(n, np.int64)
        for p in parts:
            counts[np.asarray(p, np.int64)] += 1
        weights = 1.0 / np.maximum(counts, 1)

        bs = max(len(p) for p in parts)
        blocks = torch.as_tensor(csr_diag_blocks(csr, parts, bs), device=device)
        gather = np.zeros((k, bs), np.int64)
        valid = np.zeros((k, bs), np.float64)
        for bi, p in enumerate(parts):
            gather[bi, : len(p)] = p
            valid[bi, : len(p)] = 1.0
        with full_f32_matmul():
            inv_blocks = torch.linalg.inv(blocks)
        wdtype = real_dtype_for(blocks.dtype) if blocks.is_complex() else blocks.dtype
        return cls(
            torch.as_tensor(gather, device=device),
            inv_blocks,
            torch.as_tensor(weights, dtype=wdtype, device=device),
            torch.as_tensor(valid, dtype=wdtype, device=device),
        )

    def matvec(self, r):
        mask = self.valid_mask.to(r.dtype)
        r_blocks = r[self.gather_idx] * mask  # (k, bs)
        with full_f32_matmul():
            x_blocks = torch.einsum("kij,kj->ki", self.inv_blocks.to(r.dtype), r_blocks)
        x_blocks = x_blocks * mask
        out = torch.zeros_like(r).index_add_(0, self.gather_idx.reshape(-1), x_blocks.reshape(-1))
        return out * self.weights.to(out.dtype)


class BlockJacobi(AdditiveSchwarz):
    """Non-overlapping special case (overlap = 0): weights are all 1."""

    @classmethod
    def from_csr(cls, csr: CsrMatrix, num_blocks: int, overlap: int = 0, *, device=None):
        return super().from_csr(csr, num_blocks, overlap=0, device=device)
