"""Scalar/dtype and device policy (counterpart of mathaudio_tpu/xtypes.py).

The JAX package picks its working precision from the global x64 flag;
here every builder takes an explicit ``dtype`` (default float32, the JAX
default with x64 off) and an explicit ``device`` (default ``cuda``).
"""

from __future__ import annotations

import contextlib

import torch

# Physical constants
SPEED_OF_SOUND = 343.0  # m/s at 20C
AIR_DENSITY = 1.204  # kg/m^3 at 20C
REFERENCE_PRESSURE = 20e-6  # Pa (0 dB SPL)


def default_float() -> torch.dtype:
    """float32: the working precision of the device path (the JAX package
    with x64 off). Validation passes float64 explicitly."""
    return torch.float32


def complex_dtype_for(real_dtype: torch.dtype) -> torch.dtype:
    """Complex dtype matching a real dtype's precision."""
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def real_dtype_for(complex_dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if complex_dtype == torch.complex128 else torch.float32


def pressure_to_spl(pressure_magnitude, p_ref: float = REFERENCE_PRESSURE):
    """SPL dB = 20 log10(|p| / p_ref)."""
    p = torch.clamp_min(torch.as_tensor(pressure_magnitude), 1e-30)
    return 20.0 * torch.log10(p / p_ref)


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
