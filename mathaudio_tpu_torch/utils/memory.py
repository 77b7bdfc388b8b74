"""Device-memory budgeting for batched frequency sweeps (counterpart of
mathaudio_tpu/utils/memory.py): the bytes one frequency of a batched
Helmholtz solve needs, and the batch size a byte budget allows. The
arithmetic and the defaults are the reference's, so both packages pick
the same batch; pass ``budget_bytes`` (``roomsim_fem --memory-gb``) to
size batches for another card."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MemoryEstimate:
    """Bytes needed per frequency for one batched Helmholtz solve."""

    num_dofs: int
    nnz: int
    restart: int
    levels: int = 1
    complex_bytes: int = 8  # complex64

    def per_frequency_bytes(self) -> int:
        # The GMRES basis (restart + 1, N) dominates; plus the system values
        # on each multigrid level (~nnz each, shrinking 8x per level), the
        # right-hand side and residual vectors.
        basis = (self.restart + 1) * self.num_dofs * self.complex_bytes
        vals = int(self.nnz * self.complex_bytes * 1.6)  # ELL padding factor
        mg = sum(
            int(self.nnz / (8**l) * self.complex_bytes * 1.6) for l in range(self.levels)
        )
        vectors = 8 * self.num_dofs * self.complex_bytes
        return basis + vals + mg + vectors

    def batch_size(self, budget_bytes: int) -> int:
        return max(1, budget_bytes // max(self.per_frequency_bytes(), 1))


def hbm_frequency_batch(
    num_dofs: int,
    nnz: int,
    restart: int,
    levels: int = 1,
    budget_bytes: int = 8 * 2**30,
    max_batch: int = 64,
) -> int:
    """Frequencies per batch: as many as ``budget_bytes`` holds, at most
    ``max_batch``."""
    est = MemoryEstimate(num_dofs, nnz, restart, levels)
    return min(max_batch, est.batch_size(budget_bytes))
