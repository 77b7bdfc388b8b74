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
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

MAX_DIAGONALS = 32  # kernels/dia_stencil.cu kMaxDiagonals
_MODES = {"matvec": 0, "residual": 1, "jacobi": 2}

# Launches of the CUDA kernel per mode since the last reset. A run proves
# it went through the kernel by reading these; the CPU twins never count.
LAUNCHES = {mode: 0 for mode in _MODES}


def reset_launches() -> None:
    for mode in LAUNCHES:
        LAUNCHES[mode] = 0


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
# The Hopper kernel's wrapper.
# --------------------------------------------------------------------------

_PTR = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] + [_PTR] * 11 + [
    ctypes.c_double, _PTR,
]


def _library():
    """The built kernel library, with its C signatures declared (once)."""
    from mathaudio_tpu_torch import kernels

    lib = kernels.load("dia_stencil")
    if lib.dia_stencil_c64.argtypes is None:
        for fn in (lib.dia_stencil_c64, lib.dia_stencil_c128):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"dia_stencil: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"dia_stencil: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"dia_stencil: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"dia_stencil: {name} must be contiguous")


def dia_stencil(mode: str, offsets: Tuple[int, ...], tables: DiaTables, cm, cb,
                x: Optional[torch.Tensor], r: Optional[torch.Tensor] = None,
                omega: float = 1.0) -> torch.Tensor:
    """Launch the CUDA DIA stencil kernel (kernels/dia_stencil.cu) in
    ``mode`` "matvec" | "residual" | "jacobi" on the current stream.

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
    for name, t in (("x", x), ("r", r)):
        if t is not None:
            _check(name, t, cdt, (n, nf), device)
    for name in ("k", "m", "b"):
        _check(name, getattr(tables, name), rdt, (nd, n), device)
    for name in ("dk", "dm", "db"):
        _check(name, getattr(tables, name), rdt, (n,), device)
    _check("cm", cm, cdt, (nf,), device)
    _check("cb", cb, cdt, (nf,), device)

    y = torch.empty((n, nf), dtype=cdt, device=device)
    lib = _library()
    fn = lib.dia_stencil_c64 if cdt == torch.complex64 else lib.dia_stencil_c128

    def ptr(t):
        return None if t is None else t.data_ptr()

    offs = (ctypes.c_int * nd)(*offsets)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(_MODES[mode], n, nf, nd, offs,
             ptr(tables.k), ptr(tables.m), ptr(tables.b),
             ptr(tables.dk), ptr(tables.dm), ptr(tables.db),
             ptr(cm), ptr(cb), ptr(x), ptr(r), ptr(y), float(omega), stream)
    if err != 0:
        raise RuntimeError(f"dia_stencil {mode} launch failed: CUDA error {err}")
    LAUNCHES[mode] += 1
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
