"""Single-level fast multipole method for the Helmholtz double layer
(counterpart of the single-level part of mathaudio_tpu/bem/fmm.py;
math-bem/src/core/assembly/slfmm.rs: A = N + S.D.T decomposition).

High-frequency diagonal (Rokhlin) form on a unit-sphere direction
quadrature: for |x - c_b|, |y - c_a| < |D|/sep, D = c_b - c_a,

  G(x, y) = (ik / 16 pi^2) int_{S^2} e^{ik s.(x - c_b)}
            M_L(s, D) e^{-ik s.(y - c_a)} ds,
  M_L(s, D) = sum_{l<=L} (2l+1) i^l h_l^(1)(k|D|) P_l(s.D_hat).

Leaf clusters are padded to one uniform size m; T (aggregation, (C, Q,
m)), D (diagonal translation, (C, C, Q)) and S (disaggregation, (C, Q,
m)) are dense padded tensors, so the matvec is two batched GEMVs (T and
S, cuBLAS on the GPU), one elementwise translation pass and one batched
near-field GEMV over the (P, m, m) exact near blocks. There is no
hand-written kernel: none of this is a Pallas kernel in the reference.

The build functions take ``dtype`` (the build precision) and ``device``
(default ``cuda``; raises without a GPU) and build there: the octree, the
cluster packing and the near/far lists are host numpy, every tensor is
computed on ``device``. On the GPU the FMM runs the way the reference's
chip path does: a float64 build with the stability screen of float32
execution (``stability_tau=1e4``), cast to complex64 (``SlfmmOperator.to``)
in the scatter-free ``gather_form`` (``execution_tau``, ``execution_form``:
the rule ``BemSolver`` and roomsim's FMM tier share). Its float32 products
must stay true
float32 (the screened translation series cancels terms up to tau through
the quadrature): the build functions pin ``torch.get_float32_matmul_precision``
to "highest" while they run, and the port never enables TF32.

Differences from the reference, all in what a host-CPU JAX build needed:
- the near-block quadrature and the static double-layer row sums run in
  the build precision (the reference runs them in float32 on its host for
  speed; its own measurement puts that at 2e-7 relative on the matvec);
- no power-of-two padding of pair counts (``_bucket``: XLA compile
  reuse); the series order is still rounded up to a multiple of 4, since
  the Bessel recurrence's start depends on it;
- ``ClusterBlockPreconditioner`` holds complex (C, m, m) inverses, the
  same operator as the reference's real 2m x 2m embedding;
- no accelerator switch by environment variable: ``device`` says where.

The multilevel FMM (``build_mlfmm_system``, the MLFMM tree, ``sel_form``'s
tree branch) is slice 5b of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mathaudio_tpu_torch.bem.assembly import (
    _pair_kernels,
    _self_angular_rule,
    _static_pair_kernels,
    single_layer_self_terms,
)
from mathaudio_tpu_torch.bem.mesh import SurfaceMesh
from mathaudio_tpu_torch.bem.octree import Octree
from mathaudio_tpu_torch.solvers.operators import LinearOperator
from mathaudio_tpu_torch.wave.special.spherical import spherical_jn_yn_all
from mathaudio_tpu_torch.xtypes import (
    complex_dtype_for,
    default_float,
    full_f32_matmul,
    resolve_device,
    to_precision,
)

# Stability headroom of the field evaluation's screen (and, in slice 5b,
# of the MLFMM tree build functions).
_MLFMM_STABILITY_TAU = 1.0e8


def unit_sphere_quadrature(order: int):
    """(directions (Q, 3), weights (Q,)): Gauss-Legendre in cos(theta) x
    uniform in phi."""
    n_t = order + 1
    n_p = 2 * order + 2
    xt, wt = np.polynomial.legendre.leggauss(n_t)
    phi = 2 * np.pi * np.arange(n_p) / n_p
    wp = 2 * np.pi / n_p
    ct = xt[:, None] * np.ones(n_p)[None, :]
    st = np.sqrt(1 - ct**2)
    dirs = np.stack(
        [st * np.cos(phi)[None, :], st * np.sin(phi)[None, :], ct], axis=-1
    ).reshape(-1, 3)
    w = (wt[:, None] * wp * np.ones(n_p)[None, :]).reshape(-1)
    return dirs, w


def _bmv(blocks, vecs):
    """Batched (B, I, J) x (B, J) -> (B, I): one batched GEMV, in the
    promoted precision of the two."""
    dt = torch.promote_types(blocks.dtype, vecs.dtype)
    return torch.bmm(blocks.to(dt), vecs.to(dt).unsqueeze(-1)).squeeze(-1)


def _tile(rows: int, row_bytes: int, device) -> int:
    """Rows per tile of a pass whose temporaries take ``row_bytes`` per
    row: about 256 MB of them on the GPU, 16 MB (cache-sized) elsewhere."""
    budget = 2**28 if torch.device(device).type == "cuda" else 2**24
    return max(1, min(rows, budget // max(row_bytes, 1)))


def _series_coefficients(lmax: int, kd, orders):
    """(L+1, P) coefficients (2l+1) i^l h_l(kd[p]) of the translation
    series, zero above ``orders[p]``. Masked with ``where``, never a 0/1
    product: overflowed high-l Hankel tails are inf, and inf * 0 is NaN.
    i^l comes from an exact table (pow() drifts at high l)."""
    j_all, y_all = spherical_jn_yn_all(lmax, kd)
    h = torch.complex(j_all, y_all)
    l = torch.arange(lmax + 1, device=kd.device)
    i_pow = torch.tensor([1.0, 1.0j, -1.0, -1.0j], dtype=h.dtype, device=kd.device)[l % 4]
    coef = ((2 * l + 1).to(h.dtype) * i_pow)[:, None]
    return torch.where(l[:, None] <= orders[None, :], coef * h, 0.0)


def _legendre_series(a, cos_g):
    """sum_l a[l, p] P_l(cos_g[p, q]) -> (P, Q), the Legendre recurrence
    as a loop over l accumulating in place (no (L+1, P, Q) tensor)."""
    lmax = a.shape[0] - 1
    acc = a[0][:, None] * torch.ones_like(cos_g)
    if lmax == 0:
        return acc
    p_nm1, p_n = torch.ones_like(cos_g), cos_g
    acc = acc + a[1][:, None] * p_n
    for n in range(1, lmax):
        p_np1 = ((2.0 * n + 1.0) * cos_g * p_n - n * p_nm1) / (n + 1.0)
        acc = acc + a[n + 1][:, None] * p_np1
        p_nm1, p_n = p_n, p_np1
    return acc


def _translation_sum_dirs(lmax: int, kd, d_hat, dirs, orders):
    """sum_{l<=orders[p]} (2l+1) i^l h_l(kd[p]) P_l(cos_g[p, q]) -> (P, Q)
    with cos_g = clip(d_hat @ dirs^T) computed per tile of pairs, so each
    recurrence step's working set of a few (tile, Q) arrays stays in cache
    (on the GPU, within a bounded footprint)."""
    p, q = kd.shape[0], dirs.shape[0]
    a = _series_coefficients(lmax, kd, orders)
    out = torch.empty((p, q), dtype=a.dtype, device=kd.device)
    pc = _tile(p, q * 16 * 6, kd.device)
    with full_f32_matmul():
        for p0 in range(0, p, pc):
            cos_g = torch.clamp(d_hat[p0:p0 + pc] @ dirs.T, -1.0, 1.0)
            out[p0:p0 + pc] = _legendre_series(a[:, p0:p0 + pc], cos_g)
    return out


def _stab_screen(lmax: int, kd, tau: float):
    """Stable series order per pair: the largest l whose cumulative
    amplitude (2l+1)|h_l(kd)| stays <= tau (lmax when none exceeds)."""
    j_all, y_all = spherical_jn_yn_all(lmax, kd)
    coef = (2.0 * torch.arange(lmax + 1, dtype=kd.dtype, device=kd.device) + 1.0)[:, None]
    exceed = torch.cummax(coef * torch.hypot(j_all, y_all), dim=0).values > tau
    # exceed is monotone in l: the count of orders below tau is the first
    # exceeding order, and lmax + 1 when none exceeds
    return torch.sum(~exceed, dim=0) - 1


def _translation_padded(k, d_vecs, dirs, lmax: int, orders, *, dtype, device):
    """The shared core of both translation-operator forms: (P, Q) on
    ``device`` in the complex counterpart of ``dtype``. The static order is
    rounded up to a multiple of 4 as the reference buckets it (the Bessel
    recurrence starts above it; orders above ``orders[p]`` are masked)."""
    d_vecs = np.asarray(d_vecs, float)
    q = len(dirs)
    if not len(d_vecs):
        return torch.zeros((0, q), dtype=complex_dtype_for(dtype), device=device)
    d_len = np.linalg.norm(d_vecs, axis=1)
    d_hat = d_vecs / np.maximum(d_len, 1e-300)[:, None]
    lb = 4 * ((lmax + 3) // 4)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return _translation_sum_dirs(lb, t(k * d_len), t(d_hat), t(dirs),
                                 torch.as_tensor(np.asarray(orders, np.int64), device=device))


def translation_operator(k: float, d_vecs: np.ndarray, dirs: np.ndarray, order: int, *,
                         dtype=None, device=None):
    """M_L(s, D) for a batch of translation vectors: (P, Q) complex, on
    ``device`` (default ``cuda``) in the complex counterpart of ``dtype``
    (default float32)."""
    return _translation_padded(k, d_vecs, dirs, order, np.full(len(d_vecs), order, np.int32),
                               dtype=dtype or default_float(), device=resolve_device(device))


def translation_operator_pairwise(k, d_vecs, dirs, lmax: int, orders, *, dtype=None,
                                  device=None):
    """M_L(s, D) with a per-pair truncation order (P, Q): terms with
    l > orders[p] are dropped so small cluster pairs never see the
    divergent high-l h_l(kD) tail of a level-wide order."""
    return _translation_padded(k, d_vecs, dirs, lmax, np.asarray(orders, np.int32),
                               dtype=dtype or default_float(), device=resolve_device(device))


def _stable_far_orders(k, c_centers, radii, far, order: int, tau: float, *, dtype, device):
    """Per-pair stability screen of the diagonal translation form.

    The translation series carries terms (2l+1) h_l(kD) P_l that blow up
    when l outruns kD (low-frequency breakdown); the unit-sphere
    quadrature only cancels them back down to O(1) with ~log10(amp)
    digits of precision, so amplitudes beyond the arithmetic's headroom
    (tau: ~1e8 for float64 execution, ~1e4 for float32) turn into O(1)
    noise.

    Each far pair's series order is capped at the largest l whose
    cumulative amplitude stays <= tau; pairs whose stable order falls
    below the bare propagation bandwidth ceil(k(r_a+r_b)) + 2 are DEMOTED
    to the exact near field. Returns (far_mask_updated,
    orders_per_remaining_far_pair) with pairs ordered by np.where(far).
    """
    fb, fa = np.where(far)
    if not len(fb):
        return far, np.zeros(0, np.int32)
    d_len = np.linalg.norm(c_centers[fb] - c_centers[fa], axis=1)
    krp = k * (radii[fb] + radii[fa])
    l_acc = np.minimum(
        np.ceil(krp + 4 * np.log(krp + np.pi) + 4).astype(int), order
    )
    lb = 4 * ((order + 3) // 4)  # the reference's bucketed order
    kd = torch.as_tensor(k * d_len, dtype=dtype, device=device)
    l_stab = _stab_screen(lb, kd, tau).cpu().numpy()
    l_min = np.ceil(krp).astype(int) + 2
    keep = l_stab >= np.minimum(l_min, l_acc)
    far = far.copy()
    far[fb[~keep], fa[~keep]] = False
    return far, np.minimum(l_acc, l_stab)[keep].astype(np.int32)


class SlfmmData(NamedTuple):
    """The padded FMM tensors (on the build's device).

    The two trailing optional fields are the scatter-free accumulation
    tables of ``gather_form``; ``None`` keeps the scatter matvec (index_add_,
    deterministic on the CPU; on the GPU its atomics add in an order that
    varies from run to run, so the GPU runs the gather form)."""

    clusters: torch.Tensor  # (C, m) element ids (pad -> 0), int64
    cluster_mask: torch.Tensor  # (C, m) 1/0
    t_tensor: torch.Tensor  # (C, Q, m) aggregation
    s_tensor: torch.Tensor  # (C, Q, m) disaggregation (to collocation pts)
    d_tensor: torch.Tensor  # (C, C, Q) diagonal translations (0 for near)
    quad_w: torch.Tensor  # (Q,)
    near_a: torch.Tensor  # (P,) source cluster of each near pair
    near_b: torch.Tensor  # (P,) target cluster
    near_blocks: torch.Tensor  # (P, m, m) dense near-field blocks
    diag_add: torch.Tensor  # (N,) identity/jump + self terms
    prefactor: torch.Tensor  # scalar ik/(16 pi^2)
    near_of_tgt: Optional[torch.Tensor] = None  # (C, Kn) pair ids, pad = P
    elem_pos: Optional[torch.Tensor] = None  # (N,) flat index into (C*m)


def _pad_by_target(tgt: np.ndarray, n_targets: int, pad_value: int):
    """(C, K) table of item indices grouped by target (stable order),
    padded with ``pad_value``: the scatter-to-gather inversion."""
    tgt = np.asarray(tgt, np.int64)
    counts = np.bincount(tgt, minlength=n_targets)
    kmax = max(int(counts.max(initial=0)), 1)
    table = np.full((n_targets, kmax), pad_value, np.int32)
    srt = np.argsort(tgt, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(len(tgt)) - starts[tgt[srt]]
    table[tgt[srt], rank] = srt.astype(np.int32)
    return table


def _elem_positions(clusters: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(N,) flat (cluster*m + slot) position of every element: valid
    because octree leaves partition the elements (each appears once)."""
    clusters = np.asarray(clusters)
    mask = np.asarray(mask)
    m = clusters.shape[1]
    cidx, sidx = np.nonzero(mask > 0)
    n = int(clusters[cidx, sidx].max()) + 1
    pos = np.zeros(n, np.int32)
    pos[clusters[cidx, sidx]] = (cidx * m + sidx).astype(np.int32)
    return pos


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def gather_form(op):
    """A copy of an SLFMM operator whose matvec accumulates through padded
    target-side GATHER tables instead of scatter-adds: a gather and a row
    reduction per target, the same sums in pair order, deterministic on
    the GPU. (The MLFMM operators come with slice 5b.)"""
    if isinstance(op, SlfmmOperator):
        return SlfmmOperator(_slfmm_gather_form(op.data), op.n)
    raise TypeError(f"unsupported operator {type(op).__name__}")


def sel_form(op):
    """The reference's gather_form plus per-level selection matrices of
    the MLFMM tree; for an SLFMM operator it is ``gather_form`` (the tree
    branch comes with slice 5b)."""
    return gather_form(op)


def execution_tau(dtype) -> float:
    """The stability headroom of a float64 build whose operator runs in
    ``dtype``: the reference's 1e8 for float64 execution, its chip path's
    1e4 for float32."""
    return 1.0e8 if dtype == torch.float64 else 1.0e4


def execution_form(op, dtype):
    """A float64-built operator (or preconditioner) as it runs for a solve
    in the real ``dtype``: cast to its complex counterpart, and an
    operator in gather form on the GPU (scatter-adds there are atomics in
    an order that varies from run to run)."""
    op = op.to(complex_dtype_for(dtype))
    if isinstance(op, SlfmmOperator) and op.data.diag_add.is_cuda:
        op = gather_form(op)
    return op


def _slfmm_gather_form(d: SlfmmData) -> SlfmmData:
    dev = d.clusters.device
    near_of_tgt = _pad_by_target(_host(d.near_b), d.clusters.shape[0],
                                 pad_value=d.near_b.shape[0])
    elem_pos = _elem_positions(_host(d.clusters), _host(d.cluster_mask))
    return d._replace(near_of_tgt=torch.as_tensor(near_of_tgt, dtype=torch.int64, device=dev),
                      elem_pos=torch.as_tensor(elem_pos, dtype=torch.int64, device=dev))


class SlfmmOperator(LinearOperator):
    """Matrix-free A x = (c I + near + S D T) x (slfmm.rs:150 matvec)."""

    def __init__(self, data: SlfmmData, n: int):
        self.data = data
        self.n = n

    def matvec(self, x):
        d = self.data
        mask = d.cluster_mask.to(x.dtype)
        xc = x[d.clusters] * mask  # (C, m)
        mu = _bmv(d.t_tensor, xc)  # up: (C, Q)
        lam = torch.sum(d.d_tensor * mu[None, :, :], dim=1)  # translate
        far = d.prefactor * _bmv(d.s_tensor.transpose(1, 2), d.quad_w.to(lam.dtype) * lam)
        # the near sources come from the gathered (C, m) cluster values:
        # row gathers of xc, not P*m scalar gathers from x
        near = _bmv(d.near_blocks, xc[d.near_a])
        if d.elem_pos is not None:  # scatter-free form (gather_form)
            nearp = torch.cat([near, near.new_zeros((1, near.shape[1]))])
            near_t = torch.sum(nearp[d.near_of_tgt], dim=1)
            tot = (far + near_t) * mask
            return tot.reshape(-1)[d.elem_pos] + d.diag_add * x
        out = torch.zeros(self.n, dtype=far.dtype, device=x.device)
        out.index_add_(0, d.clusters.reshape(-1), (far * mask).reshape(-1))
        tgt = d.clusters[d.near_b]
        out.index_add_(0, tgt.reshape(-1), (near * mask[d.near_b]).reshape(-1))
        return out + d.diag_add * x

    def to(self, dtype=None, device=None) -> "SlfmmOperator":
        """A copy at the precision of the complex ``dtype`` (complex
        tensors in ``dtype``, real ones in its real counterpart) on
        ``device``; None keeps either."""
        d = self.data
        return SlfmmOperator(SlfmmData(*(None if v is None else to_precision(v, dtype, device)
                                         for v in d)), self.n)


def _leaf_level(mesh: SurfaceMesh, k: float, max_per_leaf: int, separation_ratio: float,
                expansion_order, stability_tau: float, dtype, device):
    """The front shared by the build functions: octree leaves packed into padded
    clusters, the expansion order (L ~ k r_max + 4 log(k r_max + pi) + 4
    unless given), the sphere quadrature, and the near/far classification
    after the stability screen. Returns (clusters, mask, c_centers, order,
    dirs, w, far, orders_pair)."""
    tree = Octree.build(mesh.centers, max_per_leaf=max_per_leaf)
    clusters, mask, c_centers, radii = _pack_clusters(tree.leaves, mesh.centers)
    if expansion_order is None:
        kr = k * radii.max()
        expansion_order = int(np.ceil(kr + 4 * np.log(kr + np.pi) + 4))
    dirs, w = unit_sphere_quadrature(expansion_order)
    dist = np.linalg.norm(c_centers[:, None] - c_centers[None, :], axis=-1)
    far = dist > separation_ratio * (radii[:, None] + radii[None, :])
    far, orders_pair = _stable_far_orders(k, c_centers, radii, far, expansion_order,
                                          stability_tau, dtype=dtype, device=device)
    return clusters, mask, c_centers, expansion_order, dirs, w, far, orders_pair


def _slfmm_data(clusters, mask, t_tensor, s_tensor, d_tensor, w, na, nb, near_blocks, diag_add,
                prefactor: complex, dtype, device) -> SlfmmData:
    """SlfmmData on ``device``: T and S keep their build precision (complex64
    with the float32 phases), everything else in ``dtype``'s."""
    cdtype = complex_dtype_for(dtype)

    def ids(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return SlfmmData(
        clusters=ids(clusters),
        cluster_mask=torch.as_tensor(mask, dtype=dtype, device=device),
        t_tensor=t_tensor,
        s_tensor=s_tensor,
        d_tensor=d_tensor.to(cdtype),
        quad_w=torch.as_tensor(w, dtype=dtype, device=device),
        near_a=ids(na),
        near_b=ids(nb),
        near_blocks=near_blocks.to(cdtype),
        diag_add=torch.as_tensor(diag_add, device=device).to(cdtype),
        prefactor=torch.tensor(prefactor, dtype=cdtype, device=device),
    )


def build_slfmm_system(
    mesh: SurfaceMesh,
    k: float,
    beta: complex = 0.0,
    max_per_leaf: int = 32,
    separation_ratio: float = 1.5,
    expansion_order: Optional[int] = None,
    dtype=None,
    stability_tau: float = 1.0e8,
    agg_phase_f32: bool = False,
    *,
    device=None,
) -> SlfmmOperator:
    """Assemble the SLFMM operator for the exterior CBIE
    (A = (1/2)I - D [- beta T_hyper off-diagonal approximation]) on
    ``device`` (default ``cuda``; raises without a GPU) in ``dtype``
    (default float32).

    beta != 0 adds the Burton-Miller coupling using direction-space
    factors for the far field and exact near-field blocks.

    ``stability_tau``: translation-series amplitude headroom (see
    _stable_far_orders); 1e8 suits float64 execution, pass ~1e4 when the
    matvec will run in float32/complex64. ``agg_phase_f32`` computes the
    aggregation/disaggregation phases in float32 (sound only with tau
    <= ~1e5, see ``_agg_disagg_tensors``).
    """
    dtype = dtype or default_float()
    device = resolve_device(device)
    with full_f32_matmul():
        clusters, mask, c_centers, order, dirs, w, far, orders_pair = _leaf_level(
            mesh, k, max_per_leaf, separation_ratio, expansion_order, stability_tau, dtype,
            device)
        # T: sum_g w_g e^{-ik s.(y_g - c_a)} * (-ik s.n_j) (double layer);
        # S: e^{+ik s.(x_i - c_b)}; D on far pairs: the shared level build.
        t_tensor, s_tensor, d_tensor = _level_tensors(
            mesh, clusters, mask, c_centers, far, k, dirs, w, order, dtype,
            orders_pair=orders_pair, phase_f32=agg_phase_f32, device=device,
        )
        if beta != 0.0:
            # Burton-Miller row factor: d/dn_x -> (ik s.n_x) in direction
            # space. The global prefactor already carries the CBIE minus
            # (S.D.T = -D), so +beta T needs the NEGATIVE factor here:
            # (1 - beta ik s.n_x) * (-D-form) = -D + beta T.
            s_tensor = _apply_bm_row_factor(
                s_tensor, torch.as_tensor(dirs, dtype=dtype, device=device),
                torch.as_tensor(mesh.normals[clusters], dtype=dtype, device=device),
                beta * 1j * k,
            )

        # near field: exact kernel blocks (regularized like the dense path)
        nb, na = np.where(~far)
        near_blocks = _near_blocks(mesh, clusters, mask, nb, na, k, beta, dtype, device=device)

        # Diagonal: jump term + the dense path's exact static row-sum
        # regularization of the double layer. The dense CBIE sets
        # D0_ii = -1/2 - row_sum_i (half-solid-angle identity), so
        # diag(A) = 1/2 - D0_ii = 1 + row_sum_i. BM self contributions stay
        # inside the near blocks.
        diag_add = 1.0 + _static_dlp_row_sums(mesh, dtype, device=device)

    # S.D.T expands +D (the double layer); the CBIE is A = (1/2)I - D, so
    # the far field enters with a minus sign (near blocks carry their own).
    data = _slfmm_data(clusters, mask, t_tensor, s_tensor, d_tensor, w, na, nb, near_blocks,
                       diag_add, -1j * k / (16.0 * np.pi**2), dtype, device)
    return SlfmmOperator(data, mesh.num_elements)


def _static_hyper_row_sums(mesh, quad_order: int = 3, chunk: int = 256, *, dtype, device):
    """s0_i = sum_{j != i} T0_ij with the same quadrature the near blocks
    use. On a closed surface the exact row sum of the static hypersingular
    operator is zero, so the BM diagonal uses -s0 in place of the analytic
    finite-part self term, absorbing the near-singular quadrature error
    exactly as the dense path's row-sum correction does. Chunked over rows;
    O(N^2) elementwise on the device. Returns (N,) in ``dtype``."""
    qp, qw = mesh.quad_points(quad_order)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    centers, normals, qp, qw = t(mesh.centers), t(mesh.normals), t(qp), t(qw)
    n = mesh.num_elements
    out = torch.empty(n, dtype=dtype, device=device)
    for i0 in range(0, n, chunk):
        idx = torch.arange(i0, min(n, i0 + chunk), device=device)
        _, hyp0 = _static_pair_kernels(centers[idx][:, None, None, :],
                                       normals[idx][:, None, None, :],
                                       qp[None, :, :, :], normals[None, :, None, :])
        contrib = hyp0 * qw[None, :, :]  # (chunk, N, nq)
        diag_term = torch.sum(contrib[torch.arange(len(idx), device=device), idx], dim=-1)
        out[idx] = torch.sum(contrib, dim=(-1, -2)) - diag_term
    return out


def _pair_points(centers, normals, qp, cl, nb_c, na_c):
    """Target element ids, source element ids and the broadcast point
    sets (x, nx, y, ny) of a tile of cluster pairs: (pc, mi, mj, nq, 3)."""
    bi, ai = cl[nb_c], cl[na_c]
    x = centers[bi][:, :, None, None, :]
    nx = normals[bi][:, :, None, None, :]
    y = qp[ai][:, None, :, :, :]
    ny = normals[ai][:, None, :, None, :]
    return bi, ai, x, nx, y, ny


def _near_setup(mesh, clusters, mask, nb, na, quad_order, dtype, device):
    """The near-block build functions' tensors on ``device`` and their pair tile."""
    qp, qw = mesh.quad_points(quad_order)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def ids(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    m, nq = clusters.shape[1], qp.shape[1]
    pc = _tile(len(nb), m * m * nq * 16 * 16, device)
    return (t(mesh.centers), t(mesh.normals), t(qp), t(qw), t(mask), ids(clusters), ids(nb),
            ids(na), pc)


def _near_blocks(mesh, clusters, mask, nb, na, k, beta, dtype, quad_order: int = 3, *, device):
    """Exact near-field blocks (P, m, m): minus double layer (+ BM),
    with the same static regularization self terms as the dense path,
    tiled over pairs. Same-element entries and padded slots are zero;
    the diagonal jump/self terms live in ``diag_add`` (and, with BM, the
    analytic radial self terms on the diagonal pairs' diagonals)."""
    cdtype = complex_dtype_for(dtype)
    centers, normals, qp, qw, mk, cl, nb_t, na_t, pc = _near_setup(
        mesh, clusters, mask, nb, na, quad_order, dtype, device)
    m = clusters.shape[1]
    blk = torch.empty((len(nb), m, m), dtype=cdtype, device=device)
    for p0 in range(0, len(nb), pc):
        nb_c, na_c = nb_t[p0:p0 + pc], na_t[p0:p0 + pc]
        bi, ai, x, nx, y, ny = _pair_points(centers, normals, qp, cl, nb_c, na_c)
        dg, hyp = _pair_kernels(x, nx, y, ny, k)  # (pc, mi, mj, nq)
        w = qw[ai][:, None, :, :]
        b = -torch.sum(dg * w, dim=-1)
        if beta != 0.0:
            b = b + beta * torch.sum(hyp * w, dim=-1)
        keep = ((bi[:, :, None] != ai[:, None, :]) & (mk[nb_c][:, :, None] > 0)
                & (mk[na_c][:, None, :] > 0))
        blk[p0:p0 + pc] = torch.where(keep, b, 0.0)

    if beta != 0.0:
        # self terms on diagonal pairs: analytic radial (T_k - T_0) self
        # plus -s0 (global static row-sum correction) in place of the
        # analytic static finite part: the dense path's exact-row-sum
        # regularization carried over to the FMM near field.
        self_r, self_w = _self_angular_rule(mesh)
        s0 = _static_hyper_row_sums(mesh, quad_order, dtype=dtype, device=device)
        diag_pairs = torch.as_tensor(np.nonzero(nb == na)[0], device=device)
        cl_d = cl[nb_t[diag_pairs]]  # (D, m)
        ik = 1j * k
        rr = torch.as_tensor(self_r, dtype=dtype, device=device)[cl_d].to(cdtype)
        ww = torch.as_tensor(self_w, dtype=dtype, device=device)[cl_d].to(cdtype)
        t_diff = torch.sum(ww * (ik - (torch.exp(ik * rr) - 1.0) / rr), dim=-1) / (4 * math.pi)
        t_self = (t_diff - s0[cl_d].to(cdtype)) * mk[nb_t[diag_pairs]].to(cdtype)
        blk[diag_pairs] += torch.diag_embed(beta * t_self)
    return blk


def _near_blocks_mixed(mesh, clusters, mask, nb, na, k, beta, m_elem, adm_elem,
                       dtype, quad_order: int = 3, *, device):
    """Near-field blocks for the mixed-BC SLFMM: per-column combination of
    the off-diagonal Ap = -D + beta T and Aq = S - beta K' entries
    (the dense ``_mixed_rows`` off-diagonal math restricted to near cluster
    pairs). Returns (blk_main, blk_comp): main applies Ap to unknown-p
    columns (plus the -ik adm single-layer coupling) and Aq to unknown-q
    columns; comp swaps the roles (prescribed values -> RHS). Same-element
    entries are zeroed: ALL self/jump terms live in the operator
    diagonal."""
    cdtype = complex_dtype_for(dtype)
    centers, normals, qp, qw, mk, cl, nb_t, na_t, pc = _near_setup(
        mesh, clusters, mask, nb, na, quad_order, dtype, device)
    m_d = torch.as_tensor(m_elem, dtype=dtype, device=device)
    adm_d = torch.as_tensor(np.asarray(adm_elem), device=device).to(cdtype)
    m = clusters.shape[1]
    blk_main = torch.empty((len(nb), m, m), dtype=cdtype, device=device)
    blk_comp = torch.empty_like(blk_main)
    for p0 in range(0, len(nb), pc):
        nb_c, na_c = nb_t[p0:p0 + pc], na_t[p0:p0 + pc]
        bi, ai, x, nx, y, ny = _pair_points(centers, normals, qp, cl, nb_c, na_c)
        dg, hyp = _pair_kernels(x, nx, y, ny, k)  # (pc, mi, mj, nq)
        w = qw[ai][:, None, :, :].to(cdtype)
        ap_off = -torch.sum(dg * w, dim=-1)
        if beta != 0.0:
            ap_off = ap_off + beta * torch.sum(hyp * w, dim=-1)
        # single layer + adjoint double layer (kernels as _mixed_rows)
        rv = y - x
        r = torch.sqrt(torch.sum(rv * rv, dim=-1))
        rs = torch.where(r < 1e-15, 1.0, r)
        g = torch.exp(1j * (k * rs).to(cdtype)) / (4.0 * math.pi * rs)
        aq_off = torch.sum(g * w, dim=-1)
        if beta != 0.0:
            ik = 1j * k
            kp = -(ik - 1.0 / rs) * g * torch.sum(rv * nx, dim=-1) / rs
            aq_off = aq_off - beta * torch.sum(kp * w, dim=-1)
        mc = m_d[ai][:, None, :].to(cdtype)  # (pc, 1, mj)
        ikadm = (-1j * k) * adm_d[ai][:, None, :]
        main = ap_off * mc + aq_off * (ikadm * mc + (1.0 - mc))
        comp = ap_off * (1.0 - mc) + aq_off * mc
        keep = ((bi[:, :, None] != ai[:, None, :]) & (mk[nb_c][:, :, None] > 0)
                & (mk[na_c][:, None, :] > 0))
        blk_main[p0:p0 + pc] = torch.where(keep, main, 0.0)
        blk_comp[p0:p0 + pc] = torch.where(keep, comp, 0.0)
    return blk_main, blk_comp


def build_slfmm_mixed_system(
    mesh: SurfaceMesh,
    k: float,
    bc,
    beta: complex = 0.0,
    incident=None,
    density: float = 1.204,
    speed_of_sound: float = 343.0,
    max_per_leaf: int = 64,
    separation_ratio: float = 2.0,
    expansion_order: Optional[int] = None,
    quad_order: int = 3,
    dtype=None,
    stability_tau: float = 1.0e8,
    *,
    device=None,
):
    """Matrix-free SLFMM system for per-element velocity/pressure BCs:
    the FMM analog of assembly.assemble_mixed_system, on ``device``
    (default ``cuda``) in ``dtype`` (default float32). Prescribed values
    are routed to the RHS, so inhomogeneous BCs work at FMM scale.

    System convention (matches the dense mixed path exactly):
        Ap = 1/2 I - D + beta T       (columns where p is the unknown)
        Aq = S - beta (1/2 I + K')    (columns where q = dp/dn is unknown)

    The far field selects the layer PER COLUMN through the
    direction-space aggregation factor f_j = m_j (-ik s.n_j + ik adm_j)
    - (1 - m_j) under the CBIE-minus prefactor; the Burton-Miller
    disaggregation factor (1 - beta ik s.n_x) then produces -D + beta T
    and S - beta K' simultaneously. Prescribed values enter the RHS
    through a complementary-column operator sharing the same translations
    and disaggregation.

    Returns (operator, rhs, unknown_p) with the same solution-vector
    semantics as the dense path: u holds p on velocity elements and
    dp/dn on pressure elements."""
    dtype = dtype or default_float()
    device = resolve_device(device)
    cdtype = complex_dtype_for(dtype)
    n = mesh.num_elements
    normals = mesh.normals

    bc_types = np.asarray(bc.types, np.int32)
    bc_values = np.asarray(bc.values, complex)
    if bc_types.shape != (n,) or bc_values.shape != (n,):
        raise ValueError(f"boundary data have shapes {bc_types.shape} and {bc_values.shape}, "
                         f"expected ({n},)")
    m = (bc_types == 0).astype(float)  # 1 where p is the unknown (velocity BC)
    omega = k * speed_of_sound
    q_known = np.where(bc_types == 0, 1j * omega * density * bc_values, 0.0)
    p_known = np.where(bc_types == 1, bc_values, 0.0)
    adm = getattr(bc, "admittance", None)
    adm_arr = (
        np.zeros(n, complex) if adm is None
        else np.broadcast_to(np.asarray(adm, complex), (n,)).astype(complex)
    )

    with full_f32_matmul():
        clusters, mask, c_centers, order, dirs, w, far, orders_pair = _leaf_level(
            mesh, k, max_per_leaf, separation_ratio, expansion_order, stability_tau, dtype,
            device)

        # Far-field column factors under the CBIE-minus prefactor: +S needs
        # sigma = -1 (the global minus flips it), and the admittance
        # coupling (-ik adm) * (+S) lands as sigma = +ik adm on unknown-p
        # columns.
        agg = dict(dtype=dtype, device=device)
        t_main, s_tensor = _agg_disagg_tensors(
            mesh, clusters, mask, c_centers, k, dirs,
            agg_alpha=m.astype(complex), agg_sigma=1j * k * adm_arr * m - (1.0 - m), **agg,
        )
        t_comp, _ = _agg_disagg_tensors(
            mesh, clusters, mask, c_centers, k, dirs,
            agg_alpha=(1.0 - m).astype(complex), agg_sigma=-m.astype(complex), **agg,
        )
        if beta != 0.0:
            # shared Burton-Miller row factor (see build_slfmm_system)
            s_tensor = _apply_bm_row_factor(
                s_tensor, torch.as_tensor(dirs, dtype=dtype, device=device),
                torch.as_tensor(normals[clusters], dtype=dtype, device=device), beta * 1j * k,
            )
        d_tensor = _far_translations(k, c_centers, far, dirs, order, orders_pair, dtype=dtype,
                                     device=device)

        nb, na = np.where(~far)
        blk_main, blk_comp = _near_blocks_mixed(
            mesh, clusters, mask, nb, na, k, beta, m, adm_arr, dtype,
            quad_order=quad_order, device=device,
        )

        # Diagonals (dense-path formulas, assembly._mixed_rows):
        #   ap_diag = 1/2 - D0_ii (+ beta t_self) = 1 + rowsum0 + beta t_self
        #   aq_diag = S_ii - beta/2                       (flat-element K'_ii = 0)
        rowsum0 = _host(_static_dlp_row_sums(mesh, dtype, device=device))
        ap_diag = (1.0 + rowsum0).astype(complex)
        if beta != 0.0:
            self_r, self_w = _self_angular_rule(mesh)
            ikc = 1j * k
            t_diff_self = np.sum(
                self_w * (ikc - (np.exp(ikc * self_r) - 1.0) / self_r), axis=1
            ) / (4.0 * np.pi)
            s0 = _host(_static_hyper_row_sums(mesh, quad_order, dtype=dtype, device=device))
            ap_diag = ap_diag + beta * (t_diff_self - s0)
        s_self = _host(single_layer_self_terms(mesh, k, dtype=dtype, device=device))
        aq_diag = s_self - (beta / 2.0 if beta != 0.0 else 0.0)
        diag_main = m * (ap_diag + (-1j * k * adm_arr) * aq_diag) + (1.0 - m) * aq_diag
        diag_comp = m * aq_diag + (1.0 - m) * ap_diag

    prefactor = -1j * k / (16.0 * np.pi**2)

    def operator(t_tensor, blocks, diag):
        return SlfmmOperator(_slfmm_data(
            clusters, mask, t_tensor.to(cdtype), s_tensor.to(cdtype), d_tensor, w, na, nb,
            blocks, diag, prefactor, dtype, device), n)

    op = operator(t_main, blk_main, diag_main)
    comp_op = operator(t_comp, blk_comp, diag_comp)

    centers_t = torch.as_tensor(mesh.centers, dtype=dtype, device=device)
    if incident is not None:
        rhs_inc = incident.pressure(centers_t, k).to(cdtype)
        if beta != 0.0:
            rhs_inc = rhs_inc - beta * incident.normal_derivative(
                centers_t, torch.as_tensor(normals, dtype=dtype, device=device), k
            ).to(cdtype)
    else:
        rhs_inc = torch.zeros(n, dtype=cdtype, device=device)
    known = torch.as_tensor(q_known * m + p_known * (1.0 - m), device=device).to(cdtype)
    rhs = rhs_inc - gather_form(comp_op).matvec(known)
    return op, rhs, bc_types == 0


def _pack_clusters(nodes, centers):
    """Pad octree nodes to one uniform cluster size: (element-id table,
    mask, cluster centers, radii). Shared by every FMM build."""
    c = len(nodes)
    m = max(len(nd.indices) for nd in nodes)
    cl = np.zeros((c, m), np.int32)
    mk = np.zeros((c, m))
    cc = np.zeros((c, 3))
    rr = np.zeros(c)
    for i, nd in enumerate(nodes):
        idx = nd.indices
        cl[i, : len(idx)] = idx
        mk[i, : len(idx)] = 1.0
        cc[i] = centers[idx].mean(axis=0)
        rr[i] = np.linalg.norm(centers[idx] - cc[i], axis=1).max() + 1e-12
    return cl, mk, cc, rr


def _agg_disagg_tensors(mesh, clusters, mask, c_centers, k, dirs, agg_offset=0.0,
                        single_layer=False, agg_alpha=None, agg_sigma=None,
                        phase_f32=False, *, dtype, device):
    """(T, S) padded aggregation/disaggregation tensors for one level, on
    ``device`` in the complex counterpart of ``dtype``.

    The per-source direction-space factor is ``alpha_j * (-ik s.n_j) +
    sigma_j``. ``agg_offset``: extra additive term (-ik s.n_y + agg_offset),
    the interior room system's admittance single layer merged into the
    aggregation as offset -ik beta. ``single_layer``: drop the double-layer
    normal factor (factor 1 per source point), for the radiating-field
    evaluator's -G q term. ``agg_alpha`` / ``agg_sigma``: per-element (N,)
    complex coefficients overriding the scalar forms, with which the
    mixed-BC build selects the layer per column.

    ``phase_f32`` computes the phases (and returns T, S) in float32 /
    complex64. That is sound only with the float32 stability screen (tau
    <= ~1e5): float32 rounding noise in the signature is not band-limited,
    and the screened translation series amplifies exactly the
    out-of-band content the screen assumes absent (the reference measured
    its dense-agreement gate going from 4e-6 to 1e-3 at tau = 1e8)."""
    centers = mesh.centers
    normals = mesh.normals
    qp_e, qw_e = mesh.quad_points(2)
    yg_rel = qp_e[clusters] - c_centers[:, None, None, :]
    y_rel = centers[clusters] - c_centers[:, None, :]
    n = len(centers)
    pdt = torch.float32 if phase_f32 else dtype
    cdt = complex_dtype_for(pdt)
    if agg_alpha is None and agg_sigma is None:
        if single_layer:
            alpha, sigma = np.zeros(n, complex), np.ones(n, complex)
        else:
            alpha, sigma = np.ones(n, complex), np.full(n, complex(agg_offset))
    else:
        alpha = np.zeros(n, complex) if agg_alpha is None else np.asarray(agg_alpha, complex)
        sigma = np.zeros(n, complex) if agg_sigma is None else np.asarray(agg_sigma, complex)

    def t(a, dt=pdt):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    dirs_t, mask_t = t(dirs), t(mask)
    ik = torch.complex(torch.zeros((), dtype=pdt, device=device), t(float(k)))
    with full_f32_matmul():
        phase_g = torch.einsum("qd,cmgd->cqmg", dirs_t, t(yg_rel))
        s_dot_ny = torch.einsum("qd,cmd->cqm", dirs_t, t(normals[clusters]))
        factor = (t(alpha[clusters], cdt)[:, None, :] * (-ik * s_dot_ny)
                  + t(sigma[clusters], cdt)[:, None, :])
        t_tensor = (torch.einsum("cqmg,cmg->cqm", torch.exp(-ik * phase_g),
                                 t(qw_e[clusters]).to(cdt))
                    * factor * mask_t[:, None, :])
        phase_y = torch.einsum("qd,cmd->cqm", dirs_t, t(y_rel))
    s_tensor = torch.exp(ik * phase_y) * mask_t[:, None, :].to(cdt)
    return t_tensor, s_tensor


def _apply_bm_row_factor(s_tensor, dirs, n_cl, beta_ik):
    """Burton-Miller row factor (1 - beta ik s.n_x) applied to S."""
    with full_f32_matmul():
        s_nx = torch.einsum("qd,cmd->cqm", dirs, n_cl)
    return s_tensor * (1.0 - beta_ik * s_nx)


def _far_translations(k, c_centers, far, dirs, order, orders_pair, *, dtype, device):
    """(C, C, Q) diagonal translations D[b, a] of the far pairs (zero on
    near pairs), each far pair's series cut at its screened order."""
    c_count, q = len(c_centers), len(dirs)
    d_tensor = torch.zeros((c_count, c_count, q), dtype=complex_dtype_for(dtype), device=device)
    fb, fa = np.where(far)
    if len(fb):
        if orders_pair is None:
            orders_pair = np.full(len(fb), order, np.int32)
        vals = _translation_padded(k, c_centers[fb] - c_centers[fa], dirs, order, orders_pair,
                                   dtype=dtype, device=device)
        d_tensor[torch.as_tensor(fb, device=device), torch.as_tensor(fa, device=device)] = vals
    return d_tensor


def _level_tensors(mesh, clusters, mask, c_centers, far, k, dirs, w, order, dtype,
                   agg_offset=0.0, orders_pair=None, phase_f32=False, *, device):
    """(T, S, D) padded tensors for one level. ``orders_pair``: per-far-pair
    series truncation (np.where(far) order) from the stability screen;
    None = uniform level order."""
    t_tensor, s_tensor = _agg_disagg_tensors(mesh, clusters, mask, c_centers, k, dirs,
                                             agg_offset, phase_f32=phase_f32, dtype=dtype,
                                             device=device)
    d_tensor = _far_translations(k, c_centers, far, dirs, order, orders_pair, dtype=dtype,
                                 device=device)
    return t_tensor, s_tensor, d_tensor


def estimate_num_levels(n_elements: int, max_per_leaf: int = 32) -> int:
    """mlfmm.rs estimate_num_levels analog."""
    return max(2, int(math.ceil(math.log(max(n_elements / max_per_leaf, 1), 8))) + 1)


def build_room_fmm_system(
    mesh: SurfaceMesh,
    k: float,
    admittance: float = 0.0,
    max_per_leaf: int = 32,
    separation_ratio: float = 2.0,
    expansion_order: Optional[int] = None,
    dtype=None,
    stability_tau: float = 1.0e8,
    *,
    device=None,
) -> SlfmmOperator:
    """FMM operator for the *interior* room system
    A = (1/2)I + D - ik beta S (room_acoustics/solver.rs:909
    build_fmm_system), on ``device`` (default ``cuda``) in ``dtype``
    (default float32).

    The double layer and the admittance-scaled single layer share the
    same translations/disaggregation, so they merge into one aggregation
    factor (-ik s.n_j - ik beta) per source element.
    """
    dtype = dtype or default_float()
    device = resolve_device(device)
    with full_f32_matmul():
        clusters, mask, c_centers, order, dirs, w, far, orders_pair = _leaf_level(
            mesh, k, max_per_leaf, separation_ratio, expansion_order, stability_tau, dtype,
            device)
        # +D and -ik*beta*S merged into the aggregation factor
        # (-ik s.n) + (-ik beta): the shared level build with agg_offset.
        t_tensor, s_tensor, d_tensor = _level_tensors(
            mesh, clusters, mask, c_centers, far, k, dirs, w, order, dtype,
            agg_offset=-1j * k * admittance, orders_pair=orders_pair, device=device,
        )
        nb, na = np.where(~far)
        near_blocks = _room_near_blocks(mesh, clusters, mask, nb, na, k, admittance, dtype,
                                        device=device)
        # Self terms: jump + static-D0 solid-angle diagonal - ik beta S_ii.
        # The dense path forces each static double-layer row to sum to
        # -1/2, i.e. D0_ii = -1/2 - row_sum_i, so diag(A) = 1/2 + D0_ii - ik
        # beta S_ii = -row_sum_i - ik beta S_ii. This absorbs quadrature
        # error and the mesh's normal orientation (room meshes carry
        # into-the-fluid normals, where the naive +1/2 is wrong by 1).
        s_self = single_layer_self_terms(mesh, k, dtype=dtype, device=device)
        row0 = _static_dlp_row_sums(mesh, dtype, device=device)
        diag_add = -row0 - 1j * k * admittance * s_self

    # interior system adds +D (and the merged -ik beta S): positive sign
    data = _slfmm_data(clusters, mask, t_tensor, s_tensor, d_tensor, w, na, nb, near_blocks,
                       diag_add, 1j * k / (16.0 * np.pi**2), dtype, device)
    return SlfmmOperator(data, mesh.num_elements)


def _static_dlp_row_sums(mesh: SurfaceMesh, dtype, chunk: int = 512, *, device):
    """sum_{j != i} int_elem_j dG0/dn_y(x_i, y) dS: the static double-layer
    row sums the dense interior path folds into its solid-angle diagonal
    (each D0 row sums to the half-solid-angle value regardless of mesh
    normal orientation or quadrature error). One O(N^2 nq) pass over row
    chunks on the device, in ``dtype``; returns (N,)."""
    qp, qw = mesh.quad_points(3)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    centers, normals, qp, qw = t(mesh.centers), t(mesh.normals), t(qp), t(qw)
    n = mesh.num_elements
    out = torch.empty(n, dtype=dtype, device=device)
    for i0 in range(0, n, chunk):
        idx = torch.arange(i0, min(n, i0 + chunk), device=device)
        x = centers[idx][:, None, None, :]
        dg0, _ = _static_pair_kernels(x, torch.zeros_like(x), qp[None, :, :, :],
                                      normals[None, :, None, :])
        s = torch.sum(dg0 * qw[None, :, :], dim=-1)  # (chunk, N)
        s[torch.arange(len(idx), device=device), idx] = 0.0  # drop the self column
        out[idx] = torch.sum(s, dim=1)
    return out


def _room_near_blocks(mesh, clusters, mask, nb, na, k, admittance, dtype, *, device):
    """Near blocks of +D - ik beta S (off-diagonal entries), tiled over
    pairs."""
    cdtype = complex_dtype_for(dtype)
    centers, normals, qp, qw, mk, cl, nb_t, na_t, pc = _near_setup(
        mesh, clusters, mask, nb, na, 3, dtype, device)
    m = clusters.shape[1]
    blk = torch.empty((len(nb), m, m), dtype=cdtype, device=device)
    for p0 in range(0, len(nb), pc):
        nb_c, na_c = nb_t[p0:p0 + pc], na_t[p0:p0 + pc]
        bi, ai, x, nx, y, ny = _pair_points(centers, normals, qp, cl, nb_c, na_c)
        dg, _ = _pair_kernels(x, nx, y, ny, k)
        rv = y - x
        r = torch.sqrt(torch.sum(rv * rv, dim=-1))
        rs = torch.where(r < 1e-15, 1.0, r)
        g = torch.exp(1j * (k * rs).to(cdtype)) / (4.0 * math.pi * rs)
        w = qw[ai][:, None, :, :].to(cdtype)
        b = torch.sum((dg - 1j * k * admittance * g) * w, dim=-1)
        keep = ((bi[:, :, None] != ai[:, None, :]) & (mk[nb_c][:, :, None] > 0)
                & (mk[na_c][:, None, :] > 0))
        blk[p0:p0 + pc] = torch.where(keep, b, 0.0)
    return blk


def near_field_csr(data: SlfmmData):
    """Sparse near-field matrix of an SLFMM system (host CSR): the exact
    near blocks plus the diagonal jump/self terms, the `nearfield_matrix`
    the reference hands to its ILU-preconditioned GMRES
    (room_acoustics/solver.rs:1015 gmres_solve_with_ilu_operator)."""
    from mathaudio_tpu_torch.solvers.sparse import CsrMatrix

    cl = _host(data.clusters)
    mk = _host(data.cluster_mask)
    nb = _host(data.near_b)
    na = _host(data.near_a)
    blocks = _host(data.near_blocks)
    diag = _host(data.diag_add)
    n = diag.shape[0]
    m = cl.shape[1]
    rows = np.repeat(cl[nb][:, :, None], m, axis=2).reshape(-1)
    cols = np.repeat(cl[na][:, None, :], m, axis=1).reshape(-1)
    valid = (
        np.repeat(mk[nb][:, :, None], m, axis=2)
        * np.repeat(mk[na][:, None, :], m, axis=1)
    ).reshape(-1) > 0
    vals = blocks.reshape(-1)
    tri_rows = np.concatenate([rows[valid], np.arange(n)])
    tri_cols = np.concatenate([cols[valid], np.arange(n)])
    tri_vals = np.concatenate([vals[valid], diag])
    return CsrMatrix.from_triplets(tri_rows, tri_cols, tri_vals, (n, n))


def near_ilu_preconditioner(op, sweeps: int = 6):
    """ILU(0) of the near-field matrix as a preconditioner for the FMM
    GMRES (solver.rs:975 solve_bem_fmm_gmres_ilu): factored on the host
    by the native C++ kernel, applied on the operator's device in its
    precision."""
    from mathaudio_tpu_torch.solvers.preconditioners.ilu import IluFixedPoint

    return IluFixedPoint.from_csr(near_field_csr(op.data), sweeps=sweeps,
                                  device=op.data.diag_add.device)


class ClusterBlockPreconditioner(LinearOperator):
    """Block-diagonal preconditioner (solver.rs:1046
    solve_bem_fmm_gmres_hierarchical): the diagonal (self) near-field
    block of every leaf cluster, inverted in one batch. O(N) setup; the
    apply is one batched GEMV. ``inv`` holds complex (C, m, m) inverses
    (the reference's real 2m x 2m embedding of the same inverses exists
    for a chip without complex arithmetic)."""

    def __init__(self, inv, clusters, mask, elem_pos, n):
        self.inv = inv  # (C, m, m) explicit complex inverses
        self.clusters = clusters
        self.mask = mask
        self.elem_pos = elem_pos  # (N,) flat gather positions (no scatter)
        self.n = n

    @classmethod
    def from_operator(cls, op) -> "ClusterBlockPreconditioner":
        data = op.data
        dev = data.diag_add.device
        cl, mk = data.clusters, data.cluster_mask
        c, m = cl.shape
        self_pairs = torch.nonzero(data.near_b == data.near_a).squeeze(1)
        blocks = torch.zeros((c, m, m), dtype=data.near_blocks.dtype, device=dev)
        blocks[data.near_b[self_pairs]] = data.near_blocks[self_pairs]
        ar = torch.arange(m, device=dev)
        blocks[:, ar, ar] += data.diag_add[cl] * mk
        # padded slots: identity row/col so the block stays invertible
        pad = mk == 0.0
        blocks.masked_fill_(pad[:, :, None] | pad[:, None, :], 0.0)
        blocks[:, ar, ar] = torch.where(pad, 1.0, blocks[:, ar, ar])
        elem_pos = torch.as_tensor(_elem_positions(_host(cl), _host(mk)), dtype=torch.int64,
                                   device=dev)
        return cls(torch.linalg.inv(blocks), cl, mk, elem_pos, int(data.diag_add.shape[0]))

    def matvec(self, r):
        mask = self.mask.to(r.dtype)
        xc = _bmv(self.inv, r[self.clusters] * mask)
        # leaves partition the elements, so the scatter-set is a
        # permutation: apply it as the inverse gather
        return (xc * mask).reshape(-1)[self.elem_pos]

    def to(self, dtype=None, device=None) -> "ClusterBlockPreconditioner":
        """A copy at the precision of the complex ``dtype`` on ``device``."""
        return ClusterBlockPreconditioner(
            *(to_precision(v, dtype, device) for v in (self.inv, self.clusters, self.mask,
                                                        self.elem_pos)), self.n)
