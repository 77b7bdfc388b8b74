"""Pairwise BEM quadrature sums of the dense collocation assembly
(counterpart of mathaudio_tpu/ops/bem_assembly.py, double-layer and
Burton–Miller sets).

For collocation points x_i and elements j (quadrature points yq, weights
w, normals ny) over a band of wavenumbers ``ks`` (F,):

- ``pairwise_double_layer`` -> (D_k (F, Ni, Nj) complex, D_0 (Ni, Nj) real)
- ``pairwise_bm``           -> (D_k, D_0, T_k (F, Ni, Nj), T_0 (Ni, Nj))

with D the double layer sum_q w dG/dn_y, T the hypersingular
sum_q w n_x.grad_x(n_y.grad_y G) and the 0 subscripts their Laplace
limits, which do not depend on k and come back once. The reference's
``vmap`` over wavenumbers is the leading F dimension here.

Each dispatches by device only: a CUDA tensor launches the hand-written
Hopper kernel (kernels/bem_pairwise.cu), a CPU tensor runs the plain
PyTorch twin (``*_ref``) beside it, and any other device raises. On CUDA
a build or launch failure raises; nothing falls back to the twins. The
i == j entries are singular and are overwritten by the assembly: compare
the two forms off the diagonal.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mathaudio_tpu_torch.xtypes import complex_dtype_for

MAX_QUAD = 16  # kernels/bem_pairwise.cu kMaxQuad
_PI4 = 4.0 * math.pi
_VARIANTS = ("double_layer", "burton_miller")

# Launches of the CUDA kernel per variant since the last reset. A run
# proves it went through the kernel by reading these; the twins never count.
LAUNCHES = {variant: 0 for variant in _VARIANTS}


def reset_launches() -> None:
    for variant in LAUNCHES:
        LAUNCHES[variant] = 0


# --------------------------------------------------------------------------
# Plain PyTorch twins: the CPU path, and the yardstick the kernel is held
# against on the card. They mirror the reference's XLA forms
# (pairwise_double_layer_xla, pairwise_bm_xla) with the quadrature sum as
# a loop, so only (F, Ni, Nj) intermediates ever exist.
# --------------------------------------------------------------------------


def _band(ks, like):
    """(F,) wavenumbers -> (F, 1, 1) in ``like``'s real dtype."""
    return ks.to(like.dtype)[:, None, None]


def pairwise_double_layer_ref(x, yq, ny, w, ks):
    """(D_k (F, Ni, Nj) complex, D_0 (Ni, Nj) real)."""
    cd = complex_dtype_for(x.dtype)
    k = _band(ks, x)
    dk = torch.zeros((k.shape[0], x.shape[0], yq.shape[0]), dtype=cd, device=x.device)
    d0 = torch.zeros((x.shape[0], yq.shape[0]), dtype=x.dtype, device=x.device)
    for q in range(yq.shape[1]):
        rv = yq[None, :, q, :] - x[:, None, :]
        r = torch.sqrt(torch.sum(rv * rv, dim=-1))
        inv_r = 1.0 / torch.clamp_min(r, 1e-15)
        r_dot_n = torch.sum(rv * ny[None, :, :], dim=-1)
        g = torch.exp(1j * (k * r).to(cd)) * (inv_r / _PI4).to(cd)
        dg = (1j * k - inv_r.to(cd)) * g * (r_dot_n * inv_r).to(cd)
        wq = w[None, :, q]
        dk += dg * wq.to(cd)
        d0 += -(inv_r**3) * r_dot_n / _PI4 * wq
    return dk, d0


def pairwise_bm_ref(x, nx, yq, ny, w, ks):
    """(D_k, D_0, T_k, T_0): D_k/T_k (F, Ni, Nj) complex, D_0/T_0 (Ni, Nj)."""
    from mathaudio_tpu_torch.bem.assembly import _pair_kernels, _static_pair_kernels

    cd = complex_dtype_for(x.dtype)
    k = _band(ks, x)
    shape_k = (k.shape[0], x.shape[0], yq.shape[0])
    dk = torch.zeros(shape_k, dtype=cd, device=x.device)
    tk = torch.zeros(shape_k, dtype=cd, device=x.device)
    d0 = torch.zeros(shape_k[1:], dtype=x.dtype, device=x.device)
    t0 = torch.zeros(shape_k[1:], dtype=x.dtype, device=x.device)
    xb, nxb, nyb = x[:, None, :], nx[:, None, :], ny[None, :, :]
    for q in range(yq.shape[1]):
        yb = yq[None, :, q, :]
        dg, hyp = _pair_kernels(xb, nxb, yb, nyb, k)
        dg0, hyp0 = _static_pair_kernels(xb, nxb, yb, nyb)
        wq = w[None, :, q]
        dk += dg * wq.to(cd)
        tk += hyp * wq.to(cd)
        d0 += dg0 * wq
        t0 += hyp0 * wq
    return dk, d0, tk, t0


# --------------------------------------------------------------------------
# The Hopper kernel's wrapper.
# --------------------------------------------------------------------------

_PTR = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int] * 5 + [_PTR] * 11


def _library():
    """The built kernel library, with its C signatures declared (once)."""
    from mathaudio_tpu_torch import kernels

    lib = kernels.load("bem_pairwise")
    if lib.bem_pairwise_f32.argtypes is None:
        for fn in (lib.bem_pairwise_f32, lib.bem_pairwise_f64):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"bem_pairwise: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"bem_pairwise: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"bem_pairwise: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"bem_pairwise: {name} must be contiguous")


def bem_pairwise(variant: str, x, nx, yq, ny, w, ks):
    """Launch the CUDA kernel (kernels/bem_pairwise.cu) for ``variant``
    "double_layer" -> (D_k, D_0) or "burton_miller" -> (D_k, D_0, T_k,
    T_0) on the current stream; ``nx`` is None for the double layer.

    Every tensor must be on one CUDA device, contiguous and of one real
    dtype, float32 or float64; D_k/T_k come back complex64/complex128.
    Raises on anything the kernel does not take."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown bem_pairwise variant {variant!r}")
    bm = variant == "burton_miller"
    if bm and nx is None:
        raise ValueError("bem_pairwise burton_miller needs nx")
    rdt = x.dtype
    if rdt not in (torch.float32, torch.float64):
        raise TypeError(f"bem_pairwise takes float32/float64, got {rdt}")
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"bem_pairwise launches on CUDA tensors, got {device}")
    if yq.dim() != 3:
        raise ValueError(f"bem_pairwise: yq must be (Nj, nq, 3), got {tuple(yq.shape)}")
    ni, (nj, nq, _), nf = x.shape[0], yq.shape, ks.shape[0]
    if not 1 <= nq <= MAX_QUAD:
        raise ValueError(f"bem_pairwise takes 1..{MAX_QUAD} quadrature points, got {nq}")
    _check("x", x, rdt, (ni, 3), device)
    if bm:
        _check("nx", nx, rdt, (ni, 3), device)
    _check("yq", yq, rdt, (nj, nq, 3), device)
    _check("ny", ny, rdt, (nj, 3), device)
    _check("w", w, rdt, (nj, nq), device)
    _check("ks", ks, rdt, (nf,), device)

    cd = complex_dtype_for(rdt)
    dk = torch.empty((nf, ni, nj), dtype=cd, device=device)
    d0 = torch.empty((ni, nj), dtype=rdt, device=device)
    tk = torch.empty_like(dk) if bm else None
    t0 = torch.empty_like(d0) if bm else None
    lib = _library()
    fn = lib.bem_pairwise_f32 if rdt == torch.float32 else lib.bem_pairwise_f64

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(int(bm), ni, nj, nq, nf, ptr(x), ptr(nx if bm else None), ptr(yq), ptr(ny),
             ptr(w), ptr(ks), ptr(dk), ptr(d0), ptr(tk), ptr(t0), stream)
    if err != 0:
        raise RuntimeError(f"bem_pairwise {variant} launch failed: CUDA error {err}")
    LAUNCHES[variant] += 1
    return (dk, d0, tk, t0) if bm else (dk, d0)


# --------------------------------------------------------------------------
# Dispatch by device: CUDA -> kernel, CPU -> plain twin.
# --------------------------------------------------------------------------


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"BEM pairwise sums have no path for device {t.device}")


def pairwise_double_layer(x, yq, ny, w, ks):
    """(D_k (F, Ni, Nj) complex, D_0 (Ni, Nj) real) for wavenumbers ks (F,)."""
    if _on_cuda(x):
        return bem_pairwise("double_layer", x, None, yq, ny, w, ks)
    return pairwise_double_layer_ref(x, yq, ny, w, ks)


def pairwise_bm(x, nx, yq, ny, w, ks):
    """(D_k, D_0, T_k, T_0) for wavenumbers ks (F,)."""
    if _on_cuda(x):
        return bem_pairwise("burton_miller", x, nx, yq, ny, w, ks)
    return pairwise_bm_ref(x, nx, yq, ny, w, ks)
