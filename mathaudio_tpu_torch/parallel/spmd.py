"""Explicit multi-rank execution (counterpart of
mathaudio_tpu/parallel/spmd.py): row-sharded ELL SpMV with a halo
exchange, collective Krylov solves, device-level additive Schwarz, and the
row-sharded dense BEM solve.

- the rayon row-parallel CSR matvec -> row-block-sharded ELL SpMV. Two
  forms: an all-gather form (any sparsity) and a halo form for banded
  matrices, where each rank receives only its neighbours' boundary rows
  (point-to-point sends to the neighbouring ranks of the axis);
- the global reductions of GMRES/CG -> all-reduces over the axis's process
  group (solvers/krylov.py ``axis_name``);
- additive Schwarz -> one overlapping subdomain per rank: a dense local
  block-inverse product plus the halo exchange of the overlap, shipped
  back to its owners;
- the dense BEM matvec -> row-block sharding of the (N, N) matrix.

The host half builds stacked per-shard tensors whose leading axis is the
shard axis, index for index as the reference does (from a ``CsrMatrix`` or a
dense array; no process group needed). The device half runs on every rank:
the per-rank functions take this rank's slices; the solve factories take
the whole stacked containers, and each rank moves its slice
``[mesh.get_local_rank(axis)]`` to its device. Outputs the reference shards
come back all-gathered, in the reference's global ``(S, R)`` shape, on every
rank.

The reference's ``ppermute`` ring wraps around: the edge shards receive
each other's rows, which no remapped index reads. Here the edge ranks
exchange nothing across the wrap and fill that halo with zeros.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mathaudio_tpu_torch.parallel.mesh import (
    _real,
    all_gather_tiled,
    axis_group,
    axis_index,
    axis_size,
    local_shard,
    use_mesh,
)
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, KrylovSolution, gmres
from mathaudio_tpu_torch.solvers.sparse import CsrMatrix
from mathaudio_tpu_torch.xtypes import full_f32_matmul, resolve_device


def partition_rows(n: int, n_shards: int) -> int:
    """Rows per shard, padding n up to a multiple of n_shards."""
    return -(-n // n_shards)


def _neighbor_perm(n_shards: int, shift: int):
    """The ring permutation sending shard i's data to shard i + shift."""
    return [(i, (i + shift) % n_shards) for i in range(n_shards)]


def _exchange(to_left, to_right, axis_name, n_shards: int):
    """(from_left, from_right): send ``to_left`` to the previous rank of the
    axis and ``to_right`` to the next, receive theirs; zeros where the ring
    would wrap (see the module docstring)."""
    from_left, from_right = torch.zeros_like(to_right), torch.zeros_like(to_left)
    if n_shards == 1:
        return from_left, from_right
    group = axis_group(axis_name)
    me = dist.get_group_rank(group, dist.get_rank())
    ops = []
    for shift, send, recv in ((+1, to_right, from_right), (-1, to_left, from_left)):
        peer = dict(_neighbor_perm(n_shards, shift))[me]
        if (peer > me) != (shift > 0):  # across the wrap
            continue
        peer = dist.get_global_rank(group, peer)
        ops += [dist.P2POp(dist.isend, _real(send), peer, group),
                dist.P2POp(dist.irecv, _real(recv), peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def halo_exchange(x_local, halo: int, axis_name, n_shards: int):
    """[left-neighbour tail | x_local | right-neighbour head]. ``halo == 0``
    (block-diagonal) skips the exchange entirely."""
    if halo == 0:
        return x_local
    from_left, from_right = _exchange(x_local[:halo].contiguous(),
                                      x_local[-halo:].contiguous(), axis_name, n_shards)
    return torch.cat([from_left, x_local, from_right])


# ---------------------------------------------------------------------------
# Row-block-sharded ELL with halo-remapped indices


@dataclasses.dataclass
class ShardedEll:
    """Row-block-sharded ELL matrix with halo-remapped column indices.

    ``indices``/``values`` are (n_shards, rows_per_shard, width). Column
    indices are buffer-local: they point into the per-rank halo buffer
    ``[left_halo | own rows | right_halo]`` of length
    ``halo + rows_per_shard + halo``. Padding slots have value 0 and point
    at an own-block slot. ``n`` is the true global dimension."""

    indices: torch.Tensor  # (S, R, W) int64, buffer-local
    values: torch.Tensor  # (S, R, W)
    halo: int
    n: int

    @property
    def n_shards(self) -> int:
        return self.indices.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.indices.shape[1]


def shard_ell(csr: CsrMatrix, n_shards: int, pad_to_multiple: int = 1, *,
              device=None) -> ShardedEll:
    """ShardedEll from host CSR, on ``device`` (default ``cuda``; raises
    without a GPU).

    The halo width is the furthest any column index reaches outside its
    own row block; it must stay within the two neighbour blocks (halo <=
    rows_per_shard), which holds for banded matrices with bandwidth <
    rows_per_shard: the structured-mesh FEM case. Raises for wider
    stencils (use the all-gather form instead)."""
    device = resolve_device(device)
    n = csr.shape[0]
    r = partition_rows(n, n_shards)
    n_pad = r * n_shards
    width, rows, offsets = csr._ell_slots(pad_to_multiple)

    # global padded ELL; padding points at its own block's first row, so
    # padding slots reach no halo
    idx = np.tile((np.arange(n_pad)[:, None] // r) * r, (1, width)).astype(np.int64)
    val = np.zeros((n_pad, width), csr.data.dtype)
    idx[rows, offsets] = csr.indices
    val[rows, offsets] = csr.data

    block_of_row = np.arange(n_pad)[:, None] // r
    block_of_col = idx // r
    reach = block_of_col - block_of_row  # in blocks
    if reach.size and (reach.min() < -1 or reach.max() > 1):
        raise ValueError(
            "matrix bandwidth exceeds one neighbor block per side "
            f"(reach {reach.min()}..{reach.max()} blocks); use all_gather "
            "sharding or fewer shards"
        )
    into_left = np.where(reach < 0, (block_of_row * r) - idx, 0)
    into_right = np.where(reach > 0, idx - (block_of_row * r + r - 1), 0)
    halo = int(max(into_left.max(initial=0), into_right.max(initial=0)))

    local = idx - block_of_row * r + halo  # buffer = [left halo | own | right halo]
    assert local.min() >= 0 and local.max() < r + 2 * halo
    return ShardedEll(
        torch.as_tensor(local.reshape(n_shards, r, width), device=device),
        torch.as_tensor(val.reshape(n_shards, r, width), device=device),
        halo,
        n,
    )


def ell_local_matvec(indices_local, values_local, x_local, halo: int, axis_name,
                     n_shards: int):
    """Per-rank SpMV: halo-exchange x, then gather and contract.
    ``indices_local``/``values_local`` are this rank's (R, W) slices."""
    buf = halo_exchange(x_local, halo, axis_name, n_shards)
    return torch.sum(values_local * buf[indices_local], dim=1)


def ell_allgather_matvec(indices_global, values_local, x_local, axis_name):
    """Any sparsity: all-gather x, gather with global column indices (one
    collective of the whole vector per matvec)."""
    x_full = all_gather_tiled(x_local, axis_group(axis_name))
    return torch.sum(values_local * x_full[indices_global], dim=1)


# ---------------------------------------------------------------------------
# Device-level additive Schwarz (schwarz.rs:31-125 across ranks)


@dataclasses.dataclass
class DeviceSchwarz:
    """One overlapping subdomain per rank (padded to a uniform size).

    ``gather_idx`` indexes the per-rank halo buffer
    ``[overlap | own rows | overlap]``; the local solve is a dense inverse
    product; overlap contributions for neighbour-owned rows are shipped
    back and summed, and the precomputed 1/count ``weights`` make the
    overlapped sum an average (schwarz.rs:125). ``overlap`` is the halo
    width in rows."""

    gather_idx: torch.Tensor  # (S, bs) int64 into the halo buffer
    inv_blocks: torch.Tensor  # (S, bs, bs)
    valid: torch.Tensor  # (S, bs) 1.0 where the slot is a real DoF
    weights: torch.Tensor  # (S, R) per-owned-row 1/count
    overlap: int

    @classmethod
    def from_csr(cls, csr: CsrMatrix, n_shards: int, overlap: int = 1, *, device=None):
        """Contiguous row blocks extended by ``overlap`` adjacency layers
        (which must stay within the two neighbour blocks). Blocks come
        straight from CSR rows (csr_diag_blocks, no global densify) and are
        inverted in one batch on ``device`` (default ``cuda``; raises
        without a GPU), in true float32 for float32 values."""
        from mathaudio_tpu_torch.solvers.preconditioners.schwarz import (
            _extend_partition,
            csr_diag_blocks,
        )

        device = resolve_device(device)
        n = csr.shape[0]
        r = partition_rows(n, n_shards)
        n_pad = r * n_shards
        parts = []
        for s in range(n_shards):
            own = list(range(s * r, min((s + 1) * r, n)))
            parts.append(_extend_partition(own, csr.indptr, csr.indices, overlap, n) if own else [])

        halo = 0
        for s, p in enumerate(parts):
            lo, hi = s * r, (s + 1) * r
            for i in p:
                if i < lo:
                    halo = max(halo, lo - i)
                elif i >= hi:
                    halo = max(halo, i - hi + 1)
        if halo > r:
            raise ValueError(f"overlap reaches beyond neighbor blocks (halo {halo} > {r})")

        counts = np.zeros(n_pad, np.int64)
        for p in parts:
            counts[np.asarray(p, np.int64)] += 1
        weights = (1.0 / np.maximum(counts, 1)).reshape(n_shards, r)

        bs = max((len(p) for p in parts if p), default=1)
        if bs > 8192:
            warnings.warn(
                f"DeviceSchwarz block size {bs} requires dense "
                f"{bs}x{bs} inversions (~{bs*bs*16/1e9:.1f} GB each as "
                f"complex128) — use more subdomains (n_shards) so blocks "
                f"stay in the low thousands",
                stacklevel=2,
            )
        blocks = csr_diag_blocks(csr, parts, bs)
        gather = np.zeros((n_shards, bs), np.int64)
        valid = np.zeros((n_shards, bs), np.float64)
        for s, p in enumerate(parts):
            idx = np.asarray(p, np.int64)
            gather[s, :len(idx)] = idx - s * r + halo  # buffer-local
            valid[s, :len(idx)] = 1.0
        with full_f32_matmul():
            inv_blocks = torch.linalg.inv(torch.as_tensor(blocks, device=device))
        wdtype = torch.as_tensor(np.zeros(1, csr.data.dtype).real).dtype
        return cls(
            torch.as_tensor(gather, device=device),
            inv_blocks,
            torch.as_tensor(valid, dtype=wdtype, device=device),
            torch.as_tensor(weights, dtype=wdtype, device=device),
            halo,
        )


def schwarz_apply_local(gather_idx, inv_block, valid, weights, r_local,
                        overlap: int, axis_name, n_shards: int):
    """Per-rank Schwarz apply (this rank's slices): halo-gather the
    residual -> dense inverse product -> scatter-add -> ship the overlap
    contributions back to their owners -> weight. Each block holds each
    DoF once, so the scatter-add has no collisions."""
    r_buf = halo_exchange(r_local, overlap, axis_name, n_shards)
    vm = valid.to(r_local.dtype)
    rb = r_buf[gather_idx] * vm
    with full_f32_matmul():
        xb = (inv_block.to(r_local.dtype) @ rb) * vm
    out_buf = torch.zeros_like(r_buf).index_add_(0, gather_idx, xb)
    if overlap:
        own = out_buf[overlap:-overlap].clone()
        # contributions this rank computed for its neighbours' rows
        from_left, from_right = _exchange(out_buf[:overlap].contiguous(),
                                          out_buf[-overlap:].contiguous(), axis_name, n_shards)
        own[-overlap:] += from_right
        own[:overlap] += from_left
    else:
        own = out_buf
    return own * weights.to(own.dtype)


# ---------------------------------------------------------------------------
# Sharded sparse solve (the user-facing layer)


@dataclasses.dataclass
class ShardedSystem:
    """The stacked tensors of a row-sharded sparse solve."""

    ell: ShardedEll
    schwarz: Optional[DeviceSchwarz]
    rhs: torch.Tensor  # (S, R)


def build_sharded_system(
    csr: CsrMatrix,
    rhs: np.ndarray,
    n_shards: int,
    schwarz_overlap: Optional[int] = 1,
    *,
    device=None,
) -> ShardedSystem:
    """Host-side build: shard rows, remap halos, factor the Schwarz blocks
    (on ``device``, default ``cuda``)."""
    ell = shard_ell(csr, n_shards, device=device)
    schwarz = (
        DeviceSchwarz.from_csr(csr, n_shards, schwarz_overlap, device=device)
        if schwarz_overlap is not None
        else None
    )
    r = ell.rows_per_shard
    rhs = np.asarray(rhs.cpu() if isinstance(rhs, torch.Tensor) else rhs)
    rhs_pad = np.zeros(r * n_shards, rhs.dtype)
    rhs_pad[: csr.shape[0]] = rhs
    return ShardedSystem(ell, schwarz, torch.as_tensor(rhs_pad.reshape(n_shards, r),
                                                       device=ell.indices.device))


def sharded_gmres_fn(mesh, config: KrylovConfig, axis: str = "dof", solver=gmres):
    """``system -> KrylovSolution`` run by every rank of the mesh axis:
    halo-exchange SpMV, all-reduced Krylov iterations, per-rank Schwarz
    preconditioning (or none if the system carries no Schwarz blocks).

    The returned ``x`` has shape (S, R) (shard-major rows) on every rank;
    ``unshard(x, n)`` flattens it back to the global vector. ``solver`` is
    any Krylov solver of solvers/krylov.py (each takes ``axis_name``)."""
    n_shards = axis_size(mesh, axis)

    def solve(system: ShardedSystem):
        ell, schwarz = system.ell, system.schwarz
        if ell.n_shards != n_shards:
            raise ValueError(f"the system has {ell.n_shards} shards, the mesh axis "
                             f"{axis!r} {n_shards} ranks")
        indices, values = local_shard(ell.indices, mesh, axis), local_shard(ell.values, mesh, axis)
        rhs = local_shard(system.rhs, mesh, axis)

        def mv(x):
            return ell_local_matvec(indices, values, x, ell.halo, axis, n_shards)

        pre = None
        if schwarz is not None:
            sz = [local_shard(t, mesh, axis) for t in (schwarz.gather_idx, schwarz.inv_blocks,
                                                       schwarz.valid, schwarz.weights)]

            def pre(r_):
                return schwarz_apply_local(*sz, r_, schwarz.overlap, axis, n_shards)

        with use_mesh(mesh):
            sol = solver(mv, rhs, config=config, preconditioner=pre, axis_name=axis)
        x = all_gather_tiled(sol.x, mesh.get_group(axis)).reshape(n_shards, -1)
        return KrylovSolution(x, sol.iterations, sol.residual_norm, sol.converged)

    return solve


def unshard(x: torch.Tensor, n: int) -> torch.Tensor:
    """(S, R) shard-major solution -> (n,) global vector."""
    return x.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# Row-block-sharded dense BEM (SURVEY.md §5)


def dense_rowblock_matvec(a_local, x_local, axis_name):
    """y_local = A_rows @ all_gather(x): the sharded dense BEM matvec. Each
    rank multiplies its (R, N) row block by the gathered vector: the
    all-gather moves N words, the product does N*R multiply-adds."""
    x_full = all_gather_tiled(x_local, axis_group(axis_name))
    with full_f32_matmul():
        return a_local @ x_full


def shard_dense_rows(a, rhs, n_shards: int, *, device=None):
    """Host-side: pad and reshape (N, N) -> (S, R, N_pad), rhs -> (S, R),
    on ``device`` (default ``cuda``). The identity on the padding rows
    keeps the system nonsingular."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    rhs = np.asarray(rhs.cpu() if isinstance(rhs, torch.Tensor) else rhs)
    device = resolve_device(device)
    n = a.shape[0]
    r = partition_rows(n, n_shards)
    n_pad = r * n_shards
    a_pad = np.zeros((n_pad, n_pad), a.dtype)
    a_pad[:n, :n] = a
    a_pad[np.arange(n, n_pad), np.arange(n, n_pad)] = 1.0
    rhs_pad = np.zeros(n_pad, rhs.dtype)
    rhs_pad[:n] = rhs
    return (
        torch.as_tensor(a_pad.reshape(n_shards, r, n_pad), device=device),
        torch.as_tensor(rhs_pad.reshape(n_shards, r), device=device),
    )


def _dense_rowblock_solve(mesh, config, axis, solver, a_blk, rhs_l):
    """One rank's part of the row-sharded dense solve on its (R, N_pad)
    block: Jacobi with its slice of the global diagonal, reductions over
    the axis; x comes back all-gathered (S, R)."""
    r = a_blk.shape[0]
    n_shards = axis_size(mesh, axis)
    rows = torch.arange(r, device=a_blk.device)
    diag = a_blk[rows, axis_index(mesh, axis) * r + rows]
    inv_d = torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, torch.ones_like(diag))
    with use_mesh(mesh):
        sol = solver(lambda x: dense_rowblock_matvec(a_blk, x, axis), rhs_l, config=config,
                     preconditioner=lambda v: inv_d * v, axis_name=axis)
    x = all_gather_tiled(sol.x, mesh.get_group(axis)).reshape(n_shards, r)
    return KrylovSolution(x, sol.iterations, sol.residual_norm, sol.converged)


def sharded_dense_gmres_fn(mesh, config: KrylovConfig, axis: str = "dof", solver=gmres):
    """Row-sharded dense solve: (a_blocks (S, R, N), rhs (S, R)) ->
    KrylovSolution with x (S, R) on every rank; each rank solves with its
    block on its device. Jacobi-preconditioned with each rank's slice of
    the global diagonal."""

    def solve(a_blocks, rhs):
        return _dense_rowblock_solve(mesh, config, axis, solver,
                                     local_shard(a_blocks, mesh, axis),
                                     local_shard(rhs, mesh, axis))

    return solve
