"""Scalar/dtype and device policy (counterpart of mathaudio_tpu/xtypes.py).

The JAX package picks its working precision from the global x64 flag;
here every builder takes an explicit ``dtype`` (default float32, the JAX
default with x64 off) and an explicit ``device`` (default ``cuda``).
"""

from __future__ import annotations

import contextlib
import math

import torch

# Physical constants
SPEED_OF_SOUND = 343.0  # m/s at 20C
AIR_DENSITY = 1.204  # kg/m^3 at 20C
REFERENCE_PRESSURE = 20e-6  # Pa (0 dB SPL)


def default_float() -> torch.dtype:
    """float32: the working precision of the device path (the JAX package
    with x64 off). Validation passes float64 explicitly."""
    return torch.float32


def default_complex() -> torch.dtype:
    """complex64, the complex counterpart of ``default_float``."""
    return torch.complex64


def complex_dtype_for(real_dtype: torch.dtype) -> torch.dtype:
    """Complex dtype matching a real dtype's precision."""
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def real_dtype_for(complex_dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if complex_dtype == torch.complex128 else torch.float32


def to_precision(t: torch.Tensor, cdtype=None, device=None) -> torch.Tensor:
    """``t`` at the precision of the complex dtype ``cdtype``: a complex
    tensor becomes ``cdtype``, a floating one its real counterpart, any
    other keeps its dtype; all move to ``device`` (None keeps both)."""
    if cdtype is not None and t.is_complex():
        return t.to(dtype=cdtype, device=device)
    if cdtype is not None and t.is_floating_point():
        return t.to(dtype=real_dtype_for(cdtype), device=device)
    return t.to(device=device)


def is_complex(x) -> bool:
    return torch.as_tensor(x).is_complex()


def as_real(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a real floating tensor. A tensor keeps its device and, when
    it is floating, its dtype, unless ``device`` or ``dtype`` names
    another; anything else becomes a tensor of ``dtype`` (default
    ``default_float``) on ``resolve_device(device)``, the GPU by default."""
    if isinstance(x, torch.Tensor):
        if dtype is None:
            dtype = x.dtype if x.is_floating_point() else default_float()
        return x.to(dtype=dtype, device=x.device if device is None else device)
    return torch.as_tensor(x, dtype=dtype or default_float(), device=resolve_device(device))


def wavenumber(frequency, speed_of_sound: float = SPEED_OF_SOUND, *, dtype=None, device=None):
    """k = 2 pi f / c, a tensor (see ``as_real`` for its dtype and device)."""
    return 2.0 * math.pi * as_real(frequency, dtype, device) / speed_of_sound


def pressure_to_spl(pressure_magnitude, p_ref: float = REFERENCE_PRESSURE):
    """SPL dB = 20 log10(|p| / p_ref)."""
    p = torch.clamp_min(torch.as_tensor(pressure_magnitude), 1e-30)
    return 20.0 * torch.log10(p / p_ref)


def log_space(start: float, stop: float, num: int, dtype=None, *, device=None):
    """Logarithmically spaced grid, endpoints inclusive, on
    ``resolve_device(device)``."""
    return torch.logspace(math.log10(start), math.log10(stop), num,
                          dtype=dtype or default_float(), device=resolve_device(device))


def lin_space(start: float, stop: float, num: int, dtype=None, *, device=None):
    return torch.linspace(start, stop, num, dtype=dtype or default_float(),
                          device=resolve_device(device))


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Raises when no GPU is present instead of
    drifting to the CPU; pass ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in true float32, never TF32.

    TF32 keeps ~10 mantissa bits; the Newton-Schulz coarse-inverse chain
    and the anchored coarse solve lose their accuracy with truncated
    inputs (the FMM notes in ARCHITECTURE.md record what truncated matmul
    inputs cost this codebase). PyTorch's default is already "highest";
    this pins it against a caller that lowered it, and restores theirs."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
