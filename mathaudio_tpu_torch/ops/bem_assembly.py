"""Pairwise BEM quadrature sums of the dense collocation assembly and
of the Kirchhoff–Helmholtz field evaluation (counterpart of
mathaudio_tpu/ops/bem_assembly.py).

For points x_i (collocation points with normals nx, or field points) and
elements j (quadrature points yq, weights w, normals ny) over a band of
wavenumbers ``k`` (F,):

- ``pairwise_double_layer`` -> (D_k (F, Ni, Nj) complex, D_0 (Ni, Nj) real)
- ``pairwise_bm``           -> (D_k, D_0, T_k (F, Ni, Nj), T_0 (Ni, Nj))
- ``pairwise_mixed``        -> (D_k, D_0, S_k, T_k, T_0, K'_k); the last
                               three are None without ``with_bm``
- ``pairwise_kh``           -> (S_k, D_k); S_k is None without
                               ``want_single``

with D the double layer sum_q w dG/dn_y, S the single layer sum_q w G, T
the hypersingular sum_q w n_x.grad_x(n_y.grad_y G), K' the adjoint double
layer sum_q w dG/dn_x, and the 0 subscripts the Laplace limits, which do
not depend on k and come back once. The reference's ``vmap`` over
wavenumbers is the leading F dimension here; a scalar ``k``, as the
reference takes it, gives the reference's planes without that dimension.

Each takes the reference's ``force`` (its ``_use_pallas``) and dispatches
by device: a CUDA tensor launches the hand-written Hopper kernel
(kernels/bem_pairwise.cu) under "auto" (the default) and "pallas", and
raises under "xla", since the port runs no twin on the card; a CPU tensor
runs the plain PyTorch twin (``*_ref``) beside it under "auto" and "xla",
and raises under "pallas", since the kernel needs the card. Any other
device raises. On CUDA a build or launch failure raises; nothing falls
back to the twins. The i == j entries are singular and are
overwritten by the assembly: compare the two forms off the diagonal.

``pairwise_double_layer_xla``, ``pairwise_bm_xla``, ``pairwise_mixed_xla``
and ``pairwise_kh_xla`` are the twins under the reference's names and
scalar-``k`` signatures: plain torch on whatever device holds the inputs,
never the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mathaudio_tpu_torch.xtypes import complex_dtype_for

MAX_QUAD = 16  # kernels/bem_pairwise.cu kMaxQuad
FORCES = ("auto", "pallas", "xla")
_PI4 = 4.0 * math.pi
# variant: (number in kernels/bem_pairwise.cu, takes nx, D_0, S_k, T_k (+ T_0), K'_k)
_VARIANTS = {
    "double_layer": (0, False, True, False, False, False),
    "burton_miller": (1, True, True, False, True, False),
    "mixed": (2, False, True, True, False, False),
    "mixed_bm": (3, True, True, True, True, True),
    "kh": (4, False, False, True, False, False),
    "kh_double": (5, False, False, False, False, False),
}

# Launches of the CUDA kernel per variant since the last reset. A run
# proves it went through the kernel by reading these; the twins never count.
LAUNCHES = {variant: 0 for variant in _VARIANTS}


def reset_launches() -> None:
    for variant in LAUNCHES:
        LAUNCHES[variant] = 0


# --------------------------------------------------------------------------
# Plain PyTorch twins: the CPU path, and the yardstick the kernel is held
# against on the card. They mirror the reference's XLA forms
# (pairwise_double_layer_xla, pairwise_bm_xla, pairwise_mixed_xla,
# pairwise_kh_xla) with the quadrature sum as a loop, so only (F, Ni, Nj)
# intermediates ever exist.
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


def _green(x, y, k, cd):
    """(rv, rs, G = e^{ik rs}/(4 pi rs)) for broadcast points, with the
    reference's guard rs = 1 where r < 1e-15."""
    rv = y - x
    r = torch.sqrt(torch.sum(rv * rv, dim=-1))
    rs = torch.where(r < 1e-15, 1.0, r)
    return rv, rs, torch.exp(1j * (k * rs).to(cd)) / (_PI4 * rs)


def pairwise_mixed_ref(x, nx, yq, ny, w, ks, with_bm: bool):
    """(D_k, D_0, S_k, T_k, T_0, K'_k); the last three None without
    ``with_bm``. k-dependent planes (F, Ni, Nj) complex, D_0/T_0 (Ni, Nj)."""
    from mathaudio_tpu_torch.bem.assembly import _pair_kernels, _static_pair_kernels

    cd = complex_dtype_for(x.dtype)
    k = _band(ks, x)
    shape_k = (k.shape[0], x.shape[0], yq.shape[0])

    def zeros_k():
        return torch.zeros(shape_k, dtype=cd, device=x.device)

    def zeros_0():
        return torch.zeros(shape_k[1:], dtype=x.dtype, device=x.device)

    dk, sk, d0 = zeros_k(), zeros_k(), zeros_0()
    tk, kp, t0 = (zeros_k(), zeros_k(), zeros_0()) if with_bm else (None, None, None)
    xb, nxb, nyb = x[:, None, :], nx[:, None, :], ny[None, :, :]
    ik = (1j * k).to(cd)
    for q in range(yq.shape[1]):
        yb = yq[None, :, q, :]
        dg, hyp = _pair_kernels(xb, nxb, yb, nyb, k)
        dg0, hyp0 = _static_pair_kernels(xb, nxb, yb, nyb)
        rv, rs, g = _green(xb, yb, k, cd)
        wq = w[None, :, q]
        wc = wq.to(cd)
        dk += dg * wc
        d0 += dg0 * wq
        sk += g * wc
        if with_bm:
            tk += hyp * wc
            t0 += hyp0 * wq
            r_dot_nx = torch.sum(rv * nxb, dim=-1)
            kp += -(ik - 1.0 / rs) * g * r_dot_nx / rs * wc
    return dk, d0, sk, tk, t0, kp


def pairwise_kh_ref(x, yq, ny, w, ks, want_single: bool = True):
    """(S_k, D_k), each (F, Ni, Nj) complex, at field points x; S_k is
    None without ``want_single``."""
    cd = complex_dtype_for(x.dtype)
    k = _band(ks, x)
    shape_k = (k.shape[0], x.shape[0], yq.shape[0])
    dk = torch.zeros(shape_k, dtype=cd, device=x.device)
    sk = torch.zeros(shape_k, dtype=cd, device=x.device) if want_single else None
    ik = (1j * k).to(cd)
    for q in range(yq.shape[1]):
        rv, rs, g = _green(x[:, None, :], yq[None, :, q, :], k, cd)
        r_dot_ny = torch.sum(rv * ny[None, :, :], dim=-1)
        wc = w[None, :, q].to(cd)
        dk += (ik - (1.0 / rs).to(cd)) * g * (r_dot_ny / rs).to(cd) * wc
        if want_single:
            sk += g * wc
    return sk, dk


# --------------------------------------------------------------------------
# The Hopper kernel's wrapper.
# --------------------------------------------------------------------------

_PTR = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int] * 5 + [_PTR] * 13


def _library():
    """The built kernel library, with its C signatures declared (once)."""
    from mathaudio_tpu_torch import kernels

    lib = kernels.load("bem_pairwise")
    if lib.bem_pairwise_f32.argtypes is None:
        for fn in (lib.bem_pairwise_f32, lib.bem_pairwise_f64):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.bem_radius_mismatches.argtypes = [_PTR, _PTR]
        lib.bem_radius_mismatches.restype = ctypes.c_int
    return lib


def radius_mismatches(device) -> int:
    """How many of the 2^32 float32 bit patterns r^2 give the row walk's r
    (one MUFU.RSQ shared with 1/r) other bits than IEEE sqrtf, or its 1/r
    other bits than the band body's rsqrtf (kernels/bem_pairwise.cu
    ``radius``). 0 means r is sqrtf everywhere. Needs the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"radius_mismatches runs on a CUDA device, got {device}")
    bad = torch.zeros((), dtype=torch.int64, device=device)
    err = _library().bem_radius_mismatches(bad.data_ptr(),
                                           torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bem_radius_mismatches launch failed: CUDA error {err}")
    return int(bad)


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
    """Launch the CUDA kernel (kernels/bem_pairwise.cu) for ``variant`` on
    the current stream and return its planes:

    - "double_layer"  -> (D_k, D_0)
    - "burton_miller" -> (D_k, D_0, T_k, T_0)
    - "mixed"         -> (D_k, D_0, S_k, None, None, None)
    - "mixed_bm"      -> (D_k, D_0, S_k, T_k, T_0, K'_k)
    - "kh"            -> (S_k, D_k)
    - "kh_double"     -> (None, D_k)

    ``nx`` is read by "burton_miller" and "mixed_bm" only (else it may be
    None). Every tensor must be on one CUDA device, contiguous and of one
    real dtype, float32 or float64; the k-dependent planes come back
    complex64/complex128. Raises on anything the kernel does not take."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown bem_pairwise variant {variant!r}")
    number, takes_nx, has_static, has_single, has_hyper, has_adjoint = _VARIANTS[variant]
    if takes_nx and nx is None:
        raise ValueError(f"bem_pairwise {variant} needs nx")
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
    if takes_nx:
        _check("nx", nx, rdt, (ni, 3), device)
    _check("yq", yq, rdt, (nj, nq, 3), device)
    _check("ny", ny, rdt, (nj, 3), device)
    _check("w", w, rdt, (nj, nq), device)
    _check("ks", ks, rdt, (nf,), device)

    cd = complex_dtype_for(rdt)

    def plane_k(wanted):
        return torch.empty((nf, ni, nj), dtype=cd, device=device) if wanted else None

    def plane_0(wanted):
        return torch.empty((ni, nj), dtype=rdt, device=device) if wanted else None

    dk = plane_k(True)
    d0 = plane_0(has_static)
    sk = plane_k(has_single)
    tk = plane_k(has_hyper)
    t0 = plane_0(has_hyper and has_static)
    kp = plane_k(has_adjoint)
    lib = _library()
    fn = lib.bem_pairwise_f32 if rdt == torch.float32 else lib.bem_pairwise_f64

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(number, ni, nj, nq, nf, ptr(x), ptr(nx if takes_nx else None), ptr(yq), ptr(ny),
             ptr(w), ptr(ks), ptr(dk), ptr(d0), ptr(sk), ptr(tk), ptr(t0), ptr(kp), stream)
    if err != 0:
        raise RuntimeError(f"bem_pairwise {variant} launch failed: CUDA error {err}")
    LAUNCHES[variant] += 1
    if variant == "double_layer":
        return dk, d0
    if variant == "burton_miller":
        return dk, d0, tk, t0
    if variant in ("kh", "kh_double"):
        return sk, dk
    return dk, d0, sk, tk, t0, kp


# --------------------------------------------------------------------------
# Dispatch, by ``force`` and device: CUDA -> kernel, CPU -> plain twin.
# --------------------------------------------------------------------------


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"BEM pairwise sums have no path for device {t.device}")


def _use_kernel(force: str, x: torch.Tensor) -> bool:
    """The reference's ``_use_pallas`` (mathaudio_tpu/ops/bem_assembly.py),
    by device: the kernel on the card, where "xla" raises; the plain twin on
    the CPU, where "pallas" raises."""
    if force not in FORCES:
        raise ValueError(f"unknown force {force!r}: expected one of {FORCES}")
    on_cuda = _on_cuda(x)
    if force == "xla" and on_cuda:
        raise ValueError(
            "force='xla' asks for the plain twin, which the port runs on the CPU only: the "
            f"inputs are on {x.device}, where force='auto' or 'pallas' launches the kernel"
        )
    if force == "pallas" and not on_cuda:
        raise ValueError(
            "force='pallas' asks for the hand-written CUDA kernel, which needs the card: "
            f"the inputs are on {x.device} (force='auto' or 'xla' runs the plain twin there)"
        )
    return on_cuda


def _wavenumbers(k, x):
    """``k`` as an (F,) band in ``x``'s dtype and device, and whether it was
    one scalar wavenumber (the reference's form)."""
    kt = torch.as_tensor(k, dtype=x.dtype, device=x.device)
    return kt.reshape(-1), kt.dim() == 0


def _single(planes, scalar: bool):
    """Drop the band dimension of the k-dependent planes of a scalar ``k``:
    the reference's (Ni, Nj) planes."""
    if not scalar:
        return planes
    return tuple(p[0] if p is not None and p.is_complex() else p for p in planes)


def pairwise_double_layer(x, yq, ny, w, k, force: str = "auto"):
    """(D_k (F, Ni, Nj) complex, D_0 (Ni, Nj) real) for wavenumbers k (F,)."""
    ks, scalar = _wavenumbers(k, x)
    if _use_kernel(force, x):
        out = bem_pairwise("double_layer", x, None, yq, ny, w, ks)
    else:
        out = pairwise_double_layer_ref(x, yq, ny, w, ks)
    return _single(out, scalar)


def pairwise_bm(x, nx, yq, ny, w, k, force: str = "auto"):
    """(D_k, D_0, T_k, T_0) for wavenumbers k (F,)."""
    ks, scalar = _wavenumbers(k, x)
    if _use_kernel(force, x):
        out = bem_pairwise("burton_miller", x, nx, yq, ny, w, ks)
    else:
        out = pairwise_bm_ref(x, nx, yq, ny, w, ks)
    return _single(out, scalar)


def pairwise_mixed(x, nx, yq, ny, w, k, with_bm: bool, force: str = "auto"):
    """(D_k, D_0, S_k, T_k, T_0, K'_k) for wavenumbers k (F,); the last
    three are None without ``with_bm``."""
    ks, scalar = _wavenumbers(k, x)
    if _use_kernel(force, x):
        out = bem_pairwise("mixed_bm" if with_bm else "mixed", x, nx, yq, ny, w, ks)
    else:
        out = pairwise_mixed_ref(x, nx, yq, ny, w, ks, with_bm)
    return _single(out, scalar)


def pairwise_kh(x, yq, ny, w, k, force: str = "auto", want_single: bool = True):
    """(S_k, D_k) at field points x for wavenumbers k (F,); S_k is None
    without ``want_single`` (rigid surfaces: dp/dn = 0)."""
    ks, scalar = _wavenumbers(k, x)
    if _use_kernel(force, x):
        out = bem_pairwise("kh" if want_single else "kh_double", x, None, yq, ny, w, ks)
    else:
        out = pairwise_kh_ref(x, yq, ny, w, ks, want_single)
    return _single(out, scalar)


# --------------------------------------------------------------------------
# The reference's XLA forms under their names: the plain torch twins at one
# scalar wavenumber, on any device (they launch nothing).
# --------------------------------------------------------------------------


def pairwise_double_layer_xla(x, yq, ny, w, k):
    """The plain torch form under the reference's name and scalar-``k``
    signature: (D_k (Ni, Nj) complex, D_0 (Ni, Nj) real)."""
    ks, scalar = _wavenumbers(k, x)
    return _single(pairwise_double_layer_ref(x, yq, ny, w, ks), scalar)


def pairwise_bm_xla(x, nx, yq, ny, w, k):
    """The plain torch form under the reference's name and scalar-``k``
    signature: (D_k, D_0, T_k, T_0), each (Ni, Nj)."""
    ks, scalar = _wavenumbers(k, x)
    return _single(pairwise_bm_ref(x, nx, yq, ny, w, ks), scalar)


def pairwise_mixed_xla(x, nx, yq, ny, w, k, with_bm: bool):
    """The plain torch form under the reference's name and scalar-``k``
    signature: (D_k, D_0, S_k, T_k, T_0, K'_k), each (Ni, Nj); the last
    three are None without ``with_bm``."""
    ks, scalar = _wavenumbers(k, x)
    return _single(pairwise_mixed_ref(x, nx, yq, ny, w, ks, with_bm), scalar)


def pairwise_kh_xla(x, yq, ny, w, k):
    """The plain torch form under the reference's name and scalar-``k``
    signature: (S_k, D_k) at field points, each (Ni, Nj)."""
    ks, scalar = _wavenumbers(k, x)
    return _single(pairwise_kh_ref(x, yq, ny, w, ks), scalar)
