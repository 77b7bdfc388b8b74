"""DIA (diagonal-offset) operator form for structured-grid FEM levels
(counterpart of mathaudio_tpu/fem/dia.py).

On the box meshes of the room sweep every P1 stiffness/mass nonzero sits
on one of D = 15 constant diagonals, so the Helmholtz operator
K - cm M + cb B over a node-major frequency batch x (N, F) is

    y[n, f] = sum_d (K_d[n] - cm_f M_d[n] + cb_f B_d[n]) x[n + off_d, f]

with three small frequency-shared real (D, N) tables and per-lane
frequency scalars cm = k^2 (shifted on coarse levels), cb = -i alpha k.

Three operations cover every use on the sweep's path:

- ``dia_matvec``    y = A x           (the GMRES fine operator)
- ``dia_residual``  y = r - A x       (V-cycle residual, GMRES b - A x)
- ``dia_jacobi``    y = x + w D^-1 (r - A x), D^-1 recomputed from the
  (N,) main-diagonal tables (x = None is the x = 0 pre-smooth)

Each dispatches by device only: a CUDA tensor launches the hand-written
Hopper kernel (kernels/dia_stencil.cu), a CPU tensor runs the plain
PyTorch twin (``*_ref``) beside it. On CUDA a build or launch failure
raises; nothing falls back to the twins.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

MAX_DIAGONALS = 32  # kernels/dia_stencil.cu kMaxDiagonals
_MODES = {"matvec": 0, "residual": 1, "jacobi": 2}

# Launches of the CUDA kernel per mode since the last reset. A run proves
# it went through the kernel by reading these; the CPU twins never count.
LAUNCHES = {mode: 0 for mode in _MODES}
# The same launches by (mode, N, F, x is None): the shapes a run launched.
LAUNCHES_BY_SHAPE: dict = {}


def reset_launches() -> None:
    for mode in LAUNCHES:
        LAUNCHES[mode] = 0
    LAUNCHES_BY_SHAPE.clear()


def dia_pattern(row_of_slot, col_of_slot) -> Tuple[Tuple[int, ...], np.ndarray]:
    """Host-side: distinct diagonal offsets and the per-slot diagonal id.

    Returns (offsets, d_of_slot) with offsets a sorted python tuple and
    d_of_slot (nnz,) int32."""
    row = _host(row_of_slot)
    col = _host(col_of_slot)
    offsets, d_of_slot = np.unique(col - row, return_inverse=True)
    return tuple(int(o) for o in offsets), d_of_slot.astype(np.int32)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def scatter_dia(vals, d_of_slot, row_of_slot, n_dia: int, n_rows: int):
    """CSR-ordered nnz values -> zero-padded DIA table (D, N).

    Entry (d, n) holds A[n, n + off_d] (zero where the diagonal leaves the
    band). Duplicate slots accumulate."""
    flat = d_of_slot.long() * n_rows + row_of_slot.long()
    out = torch.zeros(n_dia * n_rows, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, flat, vals).reshape(n_dia, n_rows)


class DiaTables(NamedTuple):
    """Frequency-shared DIA tables of one Helmholtz level (the static
    offsets travel separately)."""

    k: torch.Tensor  # (D, N) stiffness diagonals
    m: torch.Tensor  # (D, N) mass diagonals
    b: torch.Tensor  # (D, N) summed boundary-mass diagonals
    dk: torch.Tensor  # (N,) main-diagonal stiffness
    dm: torch.Tensor  # (N,)
    db: torch.Tensor  # (N,)


def dia_tables_of(asm, b_sum) -> Tuple[Tuple[int, ...], DiaTables]:
    """Build (offsets, DiaTables) from a HelmholtzAssembler.

    ``b_sum``: summed boundary-mass nnz values (zeros when no Robin walls)."""
    offsets, d_of_slot = dia_pattern(asm.row_of_slot, asm.col_of_slot)
    d_slot = torch.as_tensor(d_of_slot, device=asm.k_vals.device)
    n, nd = asm.num_nodes, len(offsets)
    d0 = offsets.index(0)

    def tab(vals):
        return scatter_dia(vals, d_slot, asm.row_of_slot, nd, n)

    tk, tm, tb = tab(asm.k_vals), tab(asm.m_vals), tab(b_sum)
    return offsets, DiaTables(tk, tm, tb, tk[d0], tm[d0], tb[d0])


def _pad_amount(offsets: Tuple[int, ...]) -> int:
    b = max(abs(o) for o in offsets) if offsets else 0
    return (b + 7) // 8 * 8


def dia_diag(tables: DiaTables, cm, cb):
    """Main diagonal (N, F) of K - cm M + cb B."""
    return (
        tables.dk[:, None].to(cm.dtype)
        - cm[None, :] * tables.dm[:, None]
        + cb[None, :] * tables.db[:, None]
    )


# --------------------------------------------------------------------------
# Plain PyTorch twins: the CPU path, and the yardstick the kernel is held
# against on the card. They mirror the reference's single-accumulator
# shifted-slice form (mathaudio_tpu/fem/dia.py dia_matvec) op for op.
# --------------------------------------------------------------------------


def dia_matvec_ref(offsets: Tuple[int, ...], tables: DiaTables, cm, cb, x):
    """y = (K - cm M + cb B) x over a node-major batch x (N, F)."""
    n = x.shape[0]
    pad = _pad_amount(offsets)
    xp = torch.zeros((n + 2 * pad, x.shape[1]), dtype=x.dtype, device=x.device)
    xp[pad:pad + n] = x
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        xs = xp[pad + off:pad + off + n]
        coef = (
            tables.k[d][:, None]
            - cm[None, :] * tables.m[d][:, None]
            + cb[None, :] * tables.b[d][:, None]
        )
        y = y + coef * xs
    return y


def dia_residual_ref(offsets: Tuple[int, ...], tables: DiaTables, cm, cb, x, r):
    """y = r - A x."""
    return r - dia_matvec_ref(offsets, tables, cm, cb, x)


def _inv_diag(tables: DiaTables, cm, cb):
    diag = dia_diag(tables, cm, cb)
    return torch.where(torch.abs(diag) > 1e-30, 1.0 / diag, 1.0)


def dia_jacobi_ref(offsets: Tuple[int, ...], tables: DiaTables, cm, cb,
                   x: Optional[torch.Tensor], r, omega: float):
    """One damped Jacobi step y = x + omega D^-1 (r - A x); ``x=None``
    means x = 0, i.e. y = omega D^-1 r."""
    om = torch.tensor(omega, dtype=r.dtype, device=r.device)
    inv_diag = _inv_diag(tables, cm, cb)
    if x is None:
        return om * inv_diag * r
    return x + om * inv_diag * (r - dia_matvec_ref(offsets, tables, cm, cb, x))


# --------------------------------------------------------------------------
# The Hopper kernel's launch plan and wrapper.
# --------------------------------------------------------------------------

ROW_GROUPS = 16  # kernels/dia_stencil.cu kGroups: node groups per block
LANE_BYTES = 256  # kUnits x 16: the bytes of a row one block covers
SHARED_LIMIT = 232448  # kSharedLimit: dynamic shared memory per block
BOX_RUNS = (2, 2, 2, 3, 2, 2, 2)  # the box stencil's runs of consecutive offsets
BOX_PLANES = (0, 0, 1, 1, 1, 2, 2)  # the window of each run when staged plane by plane
ROWS_PER_THREAD = (1, 2)  # instantiated tile heights: T = 16 x rows per thread


class StencilPlan(NamedTuple):
    """How kernels/dia_stencil.cu tiles one (offsets, N, F, precision):
    the node tile's height, and the windows of x it stages."""

    kind: int  # 0 generic, 1 box stencil (15 diagonals in runs BOX_RUNS), 2 box by planes
    rows_per_thread: int  # P; a block's node tile is T = 16 P nodes
    windows: Tuple[Tuple[int, int, int], ...]  # (first row rel. to the tile, staged base, rows)
    base: Tuple[int, ...]  # per diagonal: staged row of the tile's first node
    self_base: int  # staged row of offset 0, -1 without a main diagonal
    rows: int  # staged rows in all windows
    shared_bytes: int  # dynamic shared memory per block
    blocks: int
    c_plan: object  # the int array the C entry point takes

    @property
    def tile(self) -> int:
        return ROW_GROUPS * self.rows_per_thread


def offset_runs(offsets: Tuple[int, ...]) -> Tuple[int, ...]:
    """Lengths of the runs of consecutive offsets, in diagonal order."""
    runs = []
    for i, off in enumerate(offsets):
        if i and off == offsets[i - 1] + 1:
            runs[-1] += 1
        else:
            runs.append(1)
    return tuple(runs)


def stage_windows(offsets: Tuple[int, ...], tile: int):
    """Merge the rows a tile of ``tile`` nodes reads, [off, off + tile) per
    offset, into disjoint windows. Returns (windows, base, rows) as in
    StencilPlan."""
    merged = []
    for lo, hi in sorted({(o, o + tile) for o in offsets}):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    windows, rows = [], 0
    for lo, hi in merged:
        windows.append((lo, rows, hi - lo))
        rows += hi - lo
    base = tuple(next(b + off - lo for lo, b, length in windows if lo <= off < lo + length)
                 for off in offsets)
    return tuple(windows), base, rows


def _make_plan(offsets, n, nf, itemsize, rows_per_thread) -> StencilPlan:
    nd = len(offsets)
    tile = ROW_GROUPS * rows_per_thread
    windows, base, rows = stage_windows(offsets, tile)
    kind = 0
    if offset_runs(offsets) == BOX_RUNS:
        kind = 1
        first_of_run = itertools.accumulate(BOX_RUNS[:-1], initial=0)
        window_of = [max(w for w, (_, wb, _) in enumerate(windows) if wb <= base[d])
                     for d in first_of_run]
        if tuple(window_of) == BOX_PLANES and len(windows) == 3:
            kind = 2
    lane_tiles = -(-nf * itemsize // LANE_BYTES)
    shared = rows * LANE_BYTES + nd * tile * (16 if itemsize == 8 else 32)
    blocks = -(-n // tile) * lane_tiles
    self_base = base[offsets.index(0)] if 0 in offsets else -1
    ints = [kind, rows_per_thread, rows, self_base, min(offsets), max(offsets), len(windows), *base]
    for field in range(3):
        ints += [w[field] for w in windows]
    c_plan = (ctypes.c_int * len(ints))(*ints)
    return StencilPlan(kind, rows_per_thread, windows, base, self_base, rows, shared, blocks,
                       c_plan)


@functools.lru_cache(maxsize=256)
def stencil_plan(offsets: Tuple[int, ...], n: int, nf: int, itemsize: int, sm_count: int,
                 rows_per_thread: Optional[int] = None) -> StencilPlan:
    """The kernel's tiling for one launch shape (``itemsize`` 8 for
    complex64, 16 for complex128): two rows per thread (T = 32), or one
    where that leaves fewer than two blocks per SM or does not fit shared
    memory. ``rows_per_thread`` forces a height (for measuring the others)."""
    nd = len(offsets)
    if not 1 <= nd <= MAX_DIAGONALS:
        raise ValueError(f"dia_stencil takes 1..{MAX_DIAGONALS} diagonals, got {nd}")
    if rows_per_thread is not None and rows_per_thread not in ROWS_PER_THREAD:
        raise ValueError(f"rows_per_thread must be one of {ROWS_PER_THREAD}")
    heights = (2, 1) if rows_per_thread is None else (rows_per_thread,)
    fitting = [plan for plan in (_make_plan(offsets, n, nf, itemsize, p) for p in heights)
               if plan.shared_bytes <= SHARED_LIMIT]
    if not fitting:
        raise ValueError(f"dia_stencil: the tile's windows need more than {SHARED_LIMIT} bytes "
                         f"of shared memory for offsets {offsets}")
    if fitting[0].blocks < 2 * sm_count and len(fitting) > 1:
        return fitting[1]
    return fitting[0]


_PTR = ctypes.c_void_p
_ARGTYPES = ([ctypes.c_int, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4 + [_PTR] * 11
             + [ctypes.c_double, _PTR])


def _library():
    """The built kernel library, with its C signatures declared (once)."""
    from mathaudio_tpu_torch import kernels

    lib = kernels.load("dia_stencil")
    if lib.dia_stencil_c64.argtypes is None:
        for fn in (lib.dia_stencil_c64, lib.dia_stencil_c128):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(named, dtype, shape, device) -> None:
    """Raise unless every (name, tensor) is on ``device``, of ``dtype`` and
    ``shape``, and contiguous. Kept to one pass of cheap tests: it runs on
    every launch, and the sweep's small launches wait on the host."""
    for name, t in named:
        if t.dtype is dtype and t.shape == shape and t.device == device and t.is_contiguous():
            continue
        if t.device != device:
            raise ValueError(f"dia_stencil: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"dia_stencil: {name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"dia_stencil: {name} has shape {tuple(t.shape)}, expected {shape}")
        raise ValueError(f"dia_stencil: {name} must be contiguous")


def dia_stencil(mode: str, offsets: Tuple[int, ...], tables: DiaTables, cm, cb,
                x: Optional[torch.Tensor], r: Optional[torch.Tensor] = None,
                omega: float = 1.0, *, rows_per_thread: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA DIA stencil kernel (kernels/dia_stencil.cu) in
    ``mode`` "matvec" | "residual" | "jacobi" on the current stream, tiled
    by ``stencil_plan`` (``rows_per_thread`` forces its tile height).

    Every tensor must be on one CUDA device, contiguous, of matching
    precision: complex64 vectors with float32 tables, or complex128 with
    float64. Raises on anything the kernel does not take."""
    if mode not in _MODES:
        raise ValueError(f"unknown dia_stencil mode {mode!r}")
    like = x if x is not None else r
    if like is None:
        raise ValueError("dia_stencil needs x or r")
    if x is None and mode != "jacobi":
        raise ValueError(f"dia_stencil mode {mode!r} needs x")
    if r is None and mode != "matvec":
        raise ValueError(f"dia_stencil mode {mode!r} needs r")
    device = like.device
    if device.type != "cuda":
        raise ValueError(f"dia_stencil launches on CUDA tensors, got {device}")
    cdt = like.dtype
    if cdt not in (torch.complex64, torch.complex128):
        raise TypeError(f"dia_stencil takes complex64/complex128, got {cdt}")
    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    n, nf = like.shape
    nd = len(offsets)
    if not 1 <= nd <= MAX_DIAGONALS:
        raise ValueError(f"dia_stencil takes 1..{MAX_DIAGONALS} diagonals, got {nd}")
    _check([(name, t) for name, t in (("x", x), ("r", r)) if t is not None], cdt, (n, nf), device)
    _check((("k", tables.k), ("m", tables.m), ("b", tables.b)), rdt, (nd, n), device)
    _check((("dk", tables.dk), ("dm", tables.dm), ("db", tables.db)), rdt, (n,), device)
    _check((("cm", cm), ("cb", cb)), cdt, (nf,), device)

    itemsize = like.element_size()
    plan = stencil_plan(tuple(offsets), n, nf, itemsize, _sm_count(device.index or 0),
                        rows_per_thread)
    y = torch.empty((n, nf), dtype=cdt, device=device)
    lib = _library()
    fn = lib.dia_stencil_c64 if cdt == torch.complex64 else lib.dia_stencil_c128
    # whole 16-byte units move as one access where every row starts aligned
    vec16 = int((nf * itemsize) % 16 == 0
                and all(t.data_ptr() % 16 == 0 for t in (x, r, y) if t is not None))
    err = fn(_MODES[mode], plan.c_plan, n, nf, nd, vec16,
             tables.k.data_ptr(), tables.m.data_ptr(), tables.b.data_ptr(),
             tables.dk.data_ptr(), tables.dm.data_ptr(), tables.db.data_ptr(),
             cm.data_ptr(), cb.data_ptr(), None if x is None else x.data_ptr(),
             None if r is None else r.data_ptr(), y.data_ptr(), float(omega),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dia_stencil {mode} launch failed: CUDA error {err}")
    LAUNCHES[mode] += 1
    key = (mode, n, nf, x is None)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return y


# --------------------------------------------------------------------------
# Dispatch by device: CUDA -> kernel, CPU -> plain twin.
# --------------------------------------------------------------------------


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"DIA operator has no path for device {t.device}")


def dia_matvec(offsets: Tuple[int, ...], tables: DiaTables, cm, cb, x):
    """y = (K - cm M + cb B) x; x (N, F) complex, cm/cb (F,)."""
    if _on_cuda(x):
        return dia_stencil("matvec", offsets, tables, cm, cb, x)
    return dia_matvec_ref(offsets, tables, cm, cb, x)


def dia_residual(offsets: Tuple[int, ...], tables: DiaTables, cm, cb, x, r):
    """y = r - (K - cm M + cb B) x."""
    if _on_cuda(x):
        return dia_stencil("residual", offsets, tables, cm, cb, x, r)
    return dia_residual_ref(offsets, tables, cm, cb, x, r)


def dia_jacobi(offsets: Tuple[int, ...], tables: DiaTables, cm, cb,
               x: Optional[torch.Tensor], r, omega: float):
    """y = x + omega D^-1 (r - A x) with D = diag(K - cm M + cb B)
    recomputed from the (N,) tables; ``x=None`` means x = 0."""
    if _on_cuda(r):
        return dia_stencil("jacobi", offsets, tables, cm, cb, x, r, omega)
    return dia_jacobi_ref(offsets, tables, cm, cb, x, r, omega)
