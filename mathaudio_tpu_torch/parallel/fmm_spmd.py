"""Multi-rank FMM (counterpart of mathaudio_tpu/parallel/fmm_spmd.py): the
cluster-sharded SLFMM and MLFMM-tree matvecs and their GMRES solves.

The SLFMM matvec A x = c x + N x + S D T x is dominated by three batched
cluster product families (aggregation T, translation D, disaggregation S;
math-bem/src/core/solver/batched_blas.rs:21-320) and the near-field block
products. All four are sharded along the TARGET-cluster axis while the
vector x stays replicated:

- each rank owns C/S clusters: its rows of the aggregation and
  disaggregation tensors, its target rows of the translation tensor, and
  exactly the near pairs whose target cluster it owns;
- one tiled all-gather publishes the per-rank outgoing spectra mu = T x,
  so every rank translates from all sources;
- a second all-gather collects the per-rank element outputs; the
  replicated identity/self-term diagonal closes the matvec.

The MLFMM tree applies the same layout per level: one all-gather per level
of the spectra on the way up and of the local expansions on the way down.

The solves run GMRES with the vector replicated and no collective but the
matvecs' all-gathers, as the reference's do: every rank computes the same
iterates, so every rank takes the same stop decisions. That holds where
every value the solver reads after a gather is the same on every rank: the
right-hand side, the diagonal ``diag_add`` and the preconditioner's
tensors are taken from rank 0 once per solve (each rank builds its own,
and a CUDA build may add in an order that varies from run to run), and
the matvecs and the preconditioner use gathers only (no ``index_add_``),
so equal inputs give equal bits. Each rank's own slice of the operator
needs no such care: its products reach the others only through the
all-gathers. A solve ends with one all-gather of (iterations, residual,
sum |x|) that raises if the ranks disagree.

The host builders take the operator's data as built (not in gather form),
build the per-rank tables index for index as the reference does, and keep
the large tensors on the data's device; ``.to(dtype)`` casts a sharded
operator as ``SlfmmData.to`` does. The pytree registration of the
reference's containers has no counterpart (plain NamedTuples here).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from mathaudio_tpu_torch.bem.fmm import _bmv, _fields_to, _host, _pad_by_target
from mathaudio_tpu_torch.parallel.mesh import _real, all_gather_tiled, axis_index, mesh_device
from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres


class ShardedSlfmm(NamedTuple):
    """SLFMM tensors stacked on a leading shard axis (S, ...).

    Padded so every rank owns the same counts: ``c_pad`` clusters and
    ``p_pad`` near pairs (zero blocks and masked slots are inert). The
    element ids of the near pairs' SOURCE clusters are precomputed
    (``near_src_elems``), so the local near product gathers straight from
    the replicated x."""

    clusters: torch.Tensor  # (S, Cb, m) element ids of OWNED clusters
    cluster_mask: torch.Tensor  # (S, Cb, m)
    t_tensor: torch.Tensor  # (S, Cb, Q, m)
    s_tensor: torch.Tensor  # (S, Cb, Q, m)
    d_tensor: torch.Tensor  # (S, Cb, C_pad, Q) target rows of translations
    quad_w: torch.Tensor  # (Q,) replicated
    near_src_elems: torch.Tensor  # (S, Pb, m) global element ids
    near_src_mask: torch.Tensor  # (S, Pb, m)
    near_blocks: torch.Tensor  # (S, Pb, m, m)
    near_of_tgt: torch.Tensor  # (S, Cb, Kn) LOCAL pair ids (pad = Pb)
    diag_add: torch.Tensor  # (N,) replicated
    prefactor: torch.Tensor  # scalar
    elem_pos: torch.Tensor  # (N,) flat index into (C_pad * m), replicated

    def to(self, dtype=None, device=None) -> "ShardedSlfmm":
        """A copy at the precision of the complex ``dtype`` on ``device``
        (``SlfmmData.to``)."""
        return _fields_to(self, dtype, device)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``rows`` (on its device)."""
    out = t.new_zeros((rows,) + tuple(t.shape[1:]))
    out[: t.shape[0]] = t
    return out


def _near_pairs_by_owner(clusters, mask, near_a, near_b, near_blocks, n_shards, cb):
    """The near pairs grouped by the rank owning their TARGET cluster:
    (near_src_elems, near_src_mask, near_blocks, near_of_tgt) stacked
    (S, ...), the local target table padded with the local zero row Pb."""
    c, m = clusters.shape
    dev = near_blocks.device
    dev_of_pair = near_b // cb
    p_per = [np.flatnonzero(dev_of_pair == s) for s in range(n_shards)]
    p_max = max(max((len(p) for p in p_per), default=1), 1)
    near_src_elems = np.zeros((n_shards, p_max, m), np.int64)
    near_src_mask = np.zeros((n_shards, p_max, m), mask.dtype)
    blocks_s = near_blocks.new_zeros((n_shards, p_max, m, m))
    kn = 1
    tgt_tables = []
    for s in range(n_shards):
        ids = p_per[s]
        if len(ids):
            near_src_elems[s, :len(ids)] = clusters[near_a[ids]]
            near_src_mask[s, :len(ids)] = mask[near_a[ids]]
            blocks_s[s, :len(ids)] = near_blocks[torch.as_tensor(ids, device=dev)]
        # local target table: rows = local cluster index, entries = local
        # pair ids (pad = p_max -> the zero row of the padded product)
        tgt_local = near_b[ids] - s * cb
        counts = np.bincount(tgt_local, minlength=cb) if len(ids) else np.zeros(cb, int)
        kn = max(kn, int(counts.max(initial=0)))
        tgt_tables.append(tgt_local)
    near_of_tgt = np.full((n_shards, cb, kn), p_max, np.int64)
    for s in range(n_shards):
        fill = np.zeros(cb, np.int64)
        for p_loc, tl in enumerate(tgt_tables[s]):
            near_of_tgt[s, tl, fill[tl]] = p_loc
            fill[tl] += 1
    return near_src_elems, near_src_mask, blocks_s, near_of_tgt


def _elem_pos_padded(clusters, mask) -> np.ndarray:
    """(N,) element positions into the PADDED flat (c_pad * m) layout."""
    m = clusters.shape[1]
    cidx, sidx = np.nonzero(mask > 0)
    n = int(clusters[cidx, sidx].max()) + 1
    elem_pos = np.zeros(n, np.int64)
    elem_pos[clusters[cidx, sidx]] = cidx * m + sidx
    return elem_pos


def shard_slfmm(data, n_shards: int) -> ShardedSlfmm:
    """Host-side build: partition clusters and near pairs by target.

    ``data`` is the operator's ``.data`` as ``build_slfmm_system`` built it
    (not in gather form: the local gather tables are built per shard
    here). The translation, aggregation, disaggregation and near-block
    tensors are padded on the data's device."""
    clusters = _host(data.clusters)
    mask = _host(data.cluster_mask)
    near_a = _host(data.near_a)
    near_b = _host(data.near_b)
    dev = data.t_tensor.device

    c, m = clusters.shape
    cb = -(-c // n_shards)
    c_pad = cb * n_shards

    def pad_c(a):
        out = np.zeros((c_pad,) + a.shape[1:], a.dtype)
        out[:c] = a
        return out

    d_p = data.d_tensor.new_zeros((c_pad, c_pad, data.d_tensor.shape[2]))
    d_p[:c, :c] = data.d_tensor  # translations: target AND source axes padded
    near_src_elems, near_src_mask, blocks_s, near_of_tgt = _near_pairs_by_owner(
        clusters, mask, near_a, near_b, data.near_blocks, n_shards, cb)

    def sh(a):
        a = torch.as_tensor(a, device=dev)
        return a.reshape((n_shards, cb) + tuple(a.shape[1:]))

    def ids(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    return ShardedSlfmm(
        clusters=sh(pad_c(clusters).astype(np.int64)),
        cluster_mask=sh(pad_c(mask)),
        t_tensor=sh(_pad_rows(data.t_tensor, c_pad)),
        s_tensor=sh(_pad_rows(data.s_tensor, c_pad)),
        d_tensor=sh(d_p),
        quad_w=data.quad_w,
        near_src_elems=ids(near_src_elems),
        near_src_mask=torch.as_tensor(near_src_mask, device=dev),
        near_blocks=blocks_s,
        near_of_tgt=ids(near_of_tgt),
        diag_add=data.diag_add,
        prefactor=data.prefactor,
        elem_pos=ids(_elem_pos_padded(clusters, mask)),
    )


def _near_and_close(shard, far, x, group):
    """The near field on owned targets, summed with ``far`` (Cb, m), the
    element outputs gathered from every rank, and the diagonal."""
    dt = x.dtype
    xa = x[shard.near_src_elems] * shard.near_src_mask.to(dt)  # (Pb, m)
    near = _bmv(shard.near_blocks, xa)  # (Pb, m)
    nearp = torch.cat([near, near.new_zeros((1, near.shape[1]))])
    near_t = torch.sum(nearp[shard.near_of_tgt], dim=1)
    tot_local = (far + near_t) * shard.cluster_mask.to(dt)  # (Cb, m)
    tot_full = all_gather_tiled(tot_local, group)  # (C_pad, m)
    return tot_full.reshape(-1)[shard.elem_pos] + shard.diag_add * x


def _local_matvec(shard: ShardedSlfmm, x, axis):
    """Per-rank matvec body (this rank's slices; ``axis`` the process
    group): replicated x in, replicated y out (two tiled all-gathers)."""
    dt = x.dtype
    xc = x[shard.clusters] * shard.cluster_mask.to(dt)  # (Cb, m)
    mu_local = _bmv(shard.t_tensor, xc)  # (Cb, Q)
    mu_full = all_gather_tiled(mu_local, axis)  # (C_pad, Q)
    lam = torch.sum(shard.d_tensor * mu_full[None, :, :], dim=1)  # (Cb, Q)
    far = shard.prefactor * _bmv(shard.s_tensor.transpose(1, 2), shard.quad_w.to(dt) * lam)
    return _near_and_close(shard, far, x, axis)


_STACKED_FIELDS = (
    "clusters", "cluster_mask", "t_tensor", "s_tensor", "d_tensor",
    "near_src_elems", "near_src_mask", "near_blocks", "near_of_tgt",
)


def _strip_device_slice(shard: ShardedSlfmm, mesh, axis: str) -> ShardedSlfmm:
    """This rank's slice of every stacked field; every field on the rank's
    device."""
    idx, dev = axis_index(mesh, axis), mesh_device(mesh)
    return type(shard)(*(getattr(shard, f)[idx].to(dev) if f in _STACKED_FIELDS
                         else getattr(shard, f).to(dev) for f in shard._fields))


def sharded_slfmm_matvec_fn(mesh, axis: str = "fmm"):
    """``(sharded, x) -> y`` with x and y replicated on every rank of the
    axis; each rank runs its clusters' products on its device."""
    group = mesh.get_group(axis)

    def mv(sharded: ShardedSlfmm, x):
        shard = _strip_device_slice(sharded, mesh, axis)
        return _local_matvec(shard, x.to(mesh_device(mesh)), group)

    return mv


def _from_rank0(group, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's copy of a replicated floating or complex tensor, on every
    rank of ``group`` (other tensors are returned as they are)."""
    if not (t.is_floating_point() or t.is_complex()):
        return t
    t = t.clone().contiguous()
    dist.broadcast(_real(t), dist.get_global_rank(group, 0), group=group)
    return t


def _replicated_gmres(group, dev, config, local_matvec, shard, pre, rhs):
    """GMRES on replicated vectors with no per-step collective (see the
    module docstring): the replicated inputs from rank 0, then a check that
    the ranks ended on the same solution."""
    shard = shard._replace(diag_add=_from_rank0(group, shard.diag_add))
    if pre is not None:
        pre = copy.copy(pre)
        for name, value in vars(pre).items():
            if isinstance(value, torch.Tensor):
                setattr(pre, name, _from_rank0(group, value))
    sol = gmres(lambda v: local_matvec(shard, v, group), _from_rank0(group, rhs.to(dev)),
                config=config, preconditioner=pre)
    stamp = torch.stack([sol.iterations.to(torch.float64), sol.residual_norm.to(torch.float64),
                         torch.sum(torch.abs(sol.x)).to(torch.float64)])
    rows = all_gather_tiled(stamp.view(torch.int64)[None], group)
    if not bool(torch.all(rows == rows[:1])):
        raise RuntimeError("the ranks' replicated GMRES solves diverged: (iterations, residual, "
                           f"sum |x|) by rank {rows.view(torch.float64).tolist()}")
    return sol


def sharded_slfmm_solve_fn(
    mesh,
    config: Optional[KrylovConfig] = None,
    axis: str = "fmm",
):
    """``(sharded, pre, rhs) -> KrylovSolution``: every rank runs the
    preconditioned GMRES with x replicated (see the module docstring),
    while every operator application's cluster products stay rank-local. ``pre`` is a replicated preconditioner with
    ``.matvec`` (ClusterBlockPreconditioner) or None."""
    config = config or KrylovConfig(max_iterations=200, tolerance=1e-5, restart=48)
    group = mesh.get_group(axis)

    def solve(sharded: ShardedSlfmm, pre, rhs):
        shard = _strip_device_slice(sharded, mesh, axis)
        return _replicated_gmres(group, mesh_device(mesh), config, _local_matvec, shard, pre, rhs)

    return solve


# ---------------------------------------------------------------------------
# The hierarchical MLFMM tree over the ranks: the SLFMM's layout (TARGET-node
# sharding, replicated vector) per tree level. Each rank owns C_i/S nodes of
# every level: its leaf aggregation/disaggregation rows, the M2M reductions
# of its owned coarse nodes, the translation pairs whose target it owns, and
# the near pairs whose target leaf it owns (mlfmm.rs:954 upward/downward
# passes).


class ShardedTreeLevel(NamedTuple):
    """One tree level, stacked on a leading shard axis (S, ...)."""

    node_mask: torch.Tensor  # (S, Cb) 1 for real owned nodes
    shift_down: torch.Tensor  # (S, Cb, Qc) rows of owned nodes
    parent: torch.Tensor  # (S, Cb) GLOBAL padded index into level i-1
    interp_up: torch.Tensor  # (Qc, Q) replicated
    interp_down: torch.Tensor  # (Q, Qc) replicated
    # M2M: reduction tables of the owned nodes of the COARSER level i-1
    # (children are GLOBAL padded level-i ids into the gathered spectra)
    children_idx: torch.Tensor  # (S, Cb_coarse, Kc)
    children_mask: torch.Tensor  # (S, Cb_coarse, Kc)
    shift_up: torch.Tensor  # (S, Cb_coarse, Kc, Qc) rows per child slot
    # translations: pairs whose TARGET node is owned
    trans_src: torch.Tensor  # (S, Pb) GLOBAL padded source node ids
    trans_op: torch.Tensor  # (S, Pb, Q)
    trans_of_tgt: torch.Tensor  # (S, Cb, Kt) LOCAL pair ids (pad = Pb)


class ShardedMlfmmTree(NamedTuple):
    clusters: torch.Tensor  # (S, Cb, m) element ids of owned leaves
    cluster_mask: torch.Tensor  # (S, Cb, m)
    t_tensor: torch.Tensor  # (S, Cb, Q_leaf, m)
    s_tensor: torch.Tensor  # (S, Cb, Q_leaf, m)
    quad_w: torch.Tensor  # (Q_leaf,) replicated
    near_src_elems: torch.Tensor  # (S, Pb, m)
    near_src_mask: torch.Tensor  # (S, Pb, m)
    near_blocks: torch.Tensor  # (S, Pb, m, m)
    near_of_tgt: torch.Tensor  # (S, Cb, Kn)
    diag_add: torch.Tensor  # (N,) replicated
    prefactor: torch.Tensor
    elem_pos: torch.Tensor  # (N,) into the padded (C_leaf_pad * m) layout
    levels: tuple  # of ShardedTreeLevel, coarsest ... leaf

    def to(self, dtype=None, device=None) -> "ShardedMlfmmTree":
        """A copy at the precision of the complex ``dtype`` on ``device``
        (``MlfmmTreeData.to``), every level included."""
        return _fields_to(self, dtype, device)


def _target_tables(tgt, n_shards: int, cb: int):
    """Pairs grouped by the rank owning their TARGET node: per rank the
    global pair ids, and the (S, Cb, K) local table of local pair ids,
    padded with the local zero row Pb."""
    dev_of_pair = tgt // cb
    p_per = [np.flatnonzero(dev_of_pair == s) for s in range(n_shards)]
    p_max = max(max((len(p) for p in p_per), default=1), 1)
    kt = 1
    tables = []
    for s in range(n_shards):
        tgt_local = tgt[p_per[s]] - s * cb
        cnts = np.bincount(tgt_local, minlength=cb) if len(tgt_local) else np.zeros(cb, int)
        kt = max(kt, int(cnts.max(initial=0)))
        tables.append(tgt_local)
    of_tgt = np.full((n_shards, cb, kt), p_max, np.int64)
    for s in range(n_shards):
        fill = np.zeros(cb, np.int64)
        for p_loc, tl in enumerate(tables[s]):
            of_tgt[s, tl, fill[tl]] = p_loc
            fill[tl] += 1
    return p_per, p_max, of_tgt


def shard_mlfmm_tree(data, n_shards: int) -> ShardedMlfmmTree:
    """Host-side build from ``MlfmmTreeData`` as ``build_mlfmm_tree_system``
    built it (not in gather or selection form: pass ``op.data``)."""
    levels = list(data.levels)
    counts = [int(lv.parent.shape[0]) for lv in levels]
    cbs = [-(-c // n_shards) for c in counts]
    pads = [cb * n_shards for cb in cbs]
    dev = data.t_tensor.device
    rdt = data.cluster_mask.dtype

    def sh(a):
        a = torch.as_tensor(a, device=dev)
        return a.reshape((n_shards, a.shape[0] // n_shards) + tuple(a.shape[1:]))

    def ids(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    out_levels = []
    for i, lv in enumerate(levels):
        c, cb, c_pad = counts[i], cbs[i], pads[i]
        q = int(lv.trans_op.shape[1]) if lv.trans_op.ndim == 2 else 0
        qc = int(lv.shift_down.shape[1])
        node_mask = torch.zeros(c_pad, dtype=rdt, device=dev)
        node_mask[:c] = 1.0
        parent = np.zeros(c_pad, np.int64)
        if i > 0:
            parent[:c] = _host(lv.parent)

        # M2M tables for the COARSER level's owned nodes
        if i > 0:
            c_coarse = counts[i - 1]
            par = _host(lv.parent)
            tbl = _pad_by_target(par, c_coarse, pad_value=0)
            cnt = np.bincount(par, minlength=c_coarse)
            kc = tbl.shape[1]
            tbl_p = np.zeros((pads[i - 1], kc), np.int64)
            tbl_p[:c_coarse] = tbl
            cmask_p = np.zeros((pads[i - 1], kc), np.float64)
            cmask_p[:c_coarse] = np.arange(kc)[None, :] < cnt[:, None]
            cmask_t = torch.as_tensor(cmask_p, dtype=rdt, device=dev)
            shift_up = lv.shift_up[ids(tbl_p)] * cmask_t[:, :, None]  # (Cc_pad, Kc, Qc)
            children_idx, children_mask, shift_up = sh(tbl_p), sh(cmask_t), sh(shift_up)
        else:
            children_idx = torch.zeros((n_shards, 1, 1), dtype=torch.int64, device=dev)
            children_mask = torch.zeros((n_shards, 1, 1), dtype=rdt, device=dev)
            shift_up = lv.shift_up.new_zeros((n_shards, 1, 1, qc))

        # translation pairs grouped by the rank owning their TARGET node
        tb, ta = _host(lv.trans_tgt), _host(lv.trans_src)
        p_per, p_max, trans_of_tgt = _target_tables(tb, n_shards, cb)
        trans_src = np.zeros((n_shards, p_max), np.int64)
        trans_op = lv.trans_op.new_zeros((n_shards, p_max, max(q, 1)))
        for s in range(n_shards):
            sel = p_per[s]
            if len(sel):
                trans_src[s, :len(sel)] = ta[sel]
                trans_op[s, :len(sel)] = lv.trans_op[ids(sel)]

        out_levels.append(ShardedTreeLevel(
            node_mask=sh(node_mask),
            shift_down=sh(_pad_rows(lv.shift_down, c_pad)),
            parent=sh(parent),
            interp_up=lv.interp_up,
            interp_down=lv.interp_down,
            children_idx=children_idx,
            children_mask=children_mask,
            shift_up=shift_up,
            trans_src=ids(trans_src),
            trans_op=trans_op,
            trans_of_tgt=ids(trans_of_tgt),
        ))

    # leaf-level tensors and near pairs: shard_slfmm's layout
    clusters = _host(data.clusters)
    mask = _host(data.cluster_mask)
    c, m = clusters.shape
    cb, c_pad = cbs[-1], pads[-1]

    def pad_c(a):
        out = np.zeros((c_pad,) + a.shape[1:], a.dtype)
        out[:c] = a
        return out

    near_src_elems, near_src_mask, blocks_s, near_of_tgt = _near_pairs_by_owner(
        clusters, mask, _host(data.near_a), _host(data.near_b), data.near_blocks, n_shards, cb)
    return ShardedMlfmmTree(
        clusters=sh(pad_c(clusters).astype(np.int64)),
        cluster_mask=sh(pad_c(mask)),
        t_tensor=sh(_pad_rows(data.t_tensor, c_pad)),
        s_tensor=sh(_pad_rows(data.s_tensor, c_pad)),
        quad_w=data.quad_w,
        near_src_elems=ids(near_src_elems),
        near_src_mask=torch.as_tensor(near_src_mask, device=dev),
        near_blocks=blocks_s,
        near_of_tgt=ids(near_of_tgt),
        diag_add=data.diag_add,
        prefactor=data.prefactor,
        elem_pos=ids(_elem_pos_padded(clusters, mask)),
        levels=tuple(out_levels),
    )


_TREE_STACKED = (
    "clusters", "cluster_mask", "t_tensor", "s_tensor",
    "near_src_elems", "near_src_mask", "near_blocks", "near_of_tgt",
)
_LEVEL_STACKED = (
    "node_mask", "shift_down", "parent", "children_idx", "children_mask",
    "shift_up", "trans_src", "trans_op", "trans_of_tgt",
)


def _tree_strip(shard: ShardedMlfmmTree, mesh, axis: str) -> ShardedMlfmmTree:
    """This rank's slice of every stacked field, every level's included;
    every field on the rank's device."""
    idx, dev = axis_index(mesh, axis), mesh_device(mesh)

    def take(obj, stacked):
        return type(obj)(*(getattr(obj, f)[idx].to(dev) if f in stacked
                           else getattr(obj, f).to(dev) for f in obj._fields if f != "levels"),
                         *([tuple(take(lv, _LEVEL_STACKED) for lv in obj.levels)]
                           if "levels" in obj._fields else []))

    return take(shard, _TREE_STACKED)


def _tree_local_matvec(shard: ShardedMlfmmTree, x, axis):
    """Per-rank hierarchical matvec body (``axis`` the process group):
    replicated x in and out."""
    dt = x.dtype
    levels = shard.levels
    nlev = len(levels)

    # upward: leaf aggregation on owned leaves, then per-level M2M
    xc = x[shard.clusters] * shard.cluster_mask.to(dt)  # (Cb, m)
    mu_loc = _bmv(shard.t_tensor, xc) * levels[-1].node_mask[:, None].to(dt)
    mu_full = [None] * nlev
    mu_full[-1] = all_gather_tiled(mu_loc, axis)  # (C_pad, Q)
    for i in range(nlev - 1, 0, -1):
        lv = levels[i]
        # owned COARSE nodes: gather the children's spectra, interpolate,
        # shift, sum
        ch = mu_full[i][lv.children_idx]  # (Cbc, Kc, Q)
        up = (ch @ lv.interp_up.T.to(ch.dtype)) * lv.shift_up.to(ch.dtype)  # (Cbc, Kc, Qc)
        mu_c = torch.sum(up * lv.children_mask[:, :, None].to(up.dtype), dim=1)
        mu_c = mu_c * levels[i - 1].node_mask[:, None].to(dt)
        mu_full[i - 1] = all_gather_tiled(mu_c, axis)

    # downward: translate on owned targets, L2L from the gathered parents.
    # The leaf level's local expansion is consumed here (it parents
    # nothing), so only the nlev - 1 coarser levels gather.
    loc_full = None
    lam = None
    for i in range(nlev):
        lv = levels[i]
        contrib = lv.trans_op.to(dt) * mu_full[i][lv.trans_src]  # (Pb, Q)
        cp = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))])
        lam = torch.sum(cp[lv.trans_of_tgt], dim=1)  # (Cb, Q)
        if loc_full is not None:
            lam = lam + ((loc_full[lv.parent] * lv.shift_down.to(dt))
                         @ lv.interp_down.T.to(dt))
        lam = lam * lv.node_mask[:, None].to(dt)
        if i < nlev - 1:
            loc_full = all_gather_tiled(lam, axis)  # (C_i_pad, Q_i)

    # leaf disaggregation, then the near field on owned targets
    far = shard.prefactor * _bmv(shard.s_tensor.transpose(1, 2), shard.quad_w.to(dt) * lam)
    return _near_and_close(shard, far, x, axis)


def sharded_mlfmm_tree_matvec_fn(mesh, axis: str = "fmm"):
    """``(sharded, x) -> y`` with x and y replicated."""
    group = mesh.get_group(axis)

    def mv(sharded: ShardedMlfmmTree, x):
        return _tree_local_matvec(_tree_strip(sharded, mesh, axis), x.to(mesh_device(mesh)),
                                  group)

    return mv


def sharded_mlfmm_tree_solve_fn(mesh, config: Optional[KrylovConfig] = None,
                                axis: str = "fmm"):
    """The preconditioned GMRES on every rank with x replicated (see
    ``sharded_slfmm_solve_fn`` for why the ranks agree)."""
    config = config or KrylovConfig(max_iterations=200, tolerance=1e-5, restart=48)
    group = mesh.get_group(axis)

    def solve(sharded: ShardedMlfmmTree, pre, rhs):
        shard = _tree_strip(sharded, mesh, axis)
        return _replicated_gmres(group, mesh_device(mesh), config, _tree_local_matvec, shard,
                                 pre, rhs)

    return solve
