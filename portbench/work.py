"""The yardstick's arithmetic: the published peaks of one H100 and the
work a kernel's layer needs at a launch shape, counted from the shapes
alone (each input byte read once, each output byte written once).

These are frozen copies of the counts the repository's smoke script
(``chip_smoke.py``: ``stencil_work``, ``bound``, ``bem_bound``) used
when the kernels were ported; they stay here so that a later change to
the program or to that script cannot move the yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense float32 / float64
# rates outside the tensor cores, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"complex64": 67e12, "complex128": 34e12, "float32": 67e12, "float64": 34e12}
ITEM_BYTES = {"complex64": 8, "complex128": 16, "float32": 4, "float64": 8}

# DIA stencil: per in-band (node, diagonal) pair and lane, coefficient 7
# and complex FMA 8; per output the epilogue of each mode.
FLOPS_PER_PAIR = 15
EPILOGUE_FLOPS = {"matvec": 0, "residual": 2, "jacobi": 31}

# BEM pairwise quadrature: operations per (i, j) pair, per (i, j, q) and
# per (i, j, q, k) (add, multiply, compare, sin, cos, sqrt, rsqrt one
# each, an FMA two), and what each variant reads and writes: (reads nx,
# complex (F, Ni, Nj) planes, real (Ni, Nj) planes).
BEM_OPS = {"double_layer": (0, 22, 12), "burton_miller": (5, 41, 24)}
BEM_IO = {"double_layer": (False, 1, 1), "burton_miller": (True, 2, 2)}


def kuhn_box_offsets(nodes: int) -> tuple:
    """The 15 diagonal offsets of the P1 operator on a Kuhn-cut cube of
    ``nodes`` = (m + 1)^3 nodes numbered x fastest."""
    side = round(nodes ** (1.0 / 3.0))
    if side**3 != nodes:
        raise ValueError(f"{nodes} nodes is not a cube of nodes")
    sy, sz = side, side * side
    edges = (1, sy, sz, 1 + sy, sy + sz, 1 + sz, 1 + sy + sz)
    return tuple(sorted({0, *edges, *(-e for e in edges)}))


def stencil_work(mode: str, n: int, nf: int, offsets, cdtype: str = "complex64",
                 from_zero: bool = False):
    """(bytes, flops) one DIA call must move and do: each input read once,
    the output written once; flops over the in-band (node, diagonal) pairs."""
    cb = ITEM_BYTES[cdtype]
    rb = cb // 2
    vec = n * nf * cb
    n_vec = {"matvec": 2, "residual": 3, "jacobi": 2 if from_zero else 3}[mode]
    tables = 0 if from_zero else 3 * len(offsets) * n * rb
    diag_tables = 3 * n * rb if mode == "jacobi" else 0
    pairs = 0 if from_zero else sum(max(n - abs(o), 0) for o in offsets)
    nbytes = n_vec * vec + tables + diag_tables + 2 * nf * cb
    flops = FLOPS_PER_PAIR * pairs * nf + EPILOGUE_FLOPS[mode] * n * nf
    return nbytes, flops


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The roofline's least time: the larger of bytes over HBM bandwidth
    and operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def stencil_bound_s(mode: str, n: int, nf: int, cdtype: str = "complex64",
                    from_zero: bool = False) -> float:
    """Least seconds of one DIA call at (mode, N, F) on the Kuhn box."""
    return least_seconds(*stencil_work(mode, n, nf, kuhn_box_offsets(n), cdtype, from_zero),
                         cdtype)


def bem_work(variant: str, ni: int, nj: int, nq: int, nf: int, rdtype: str = "float32"):
    """(bytes, operations) of one pairwise assembly of ni x nj pairs, nq
    points per element, nf wavenumbers: inputs read once, planes written once."""
    rb = ITEM_BYTES[rdtype]
    reads_nx, complex_planes, real_planes = BEM_IO[variant]
    inputs = (3 * ni * (2 if reads_nx else 1) + nj * (3 * nq + 3 + nq) + nf) * rb
    outputs = (2 * nf * complex_planes + real_planes) * ni * nj * rb
    per_pair, per_point, per_point_k = BEM_OPS[variant]
    ops = ni * nj * (per_pair + nq * (per_point + per_point_k * nf))
    return inputs + outputs, ops


def bem_bound_s(variant: str, ni: int, nj: int, nq: int, nf: int, rdtype: str = "float32") -> float:
    """Least seconds of the whole band's pairwise assembly."""
    return least_seconds(*bem_work(variant, ni, nj, nq, nf, rdtype), rdtype)
