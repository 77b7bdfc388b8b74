"""The precision the check's control is computed in: the next below the
configurations' float32 with TF32 off."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 (or complex64) values to TF32's 10 mantissa bits,
    to nearest, as a tensor core rounds a product's operands."""
    if x.is_complex():
        return torch.complex(tf32(x.real.contiguous()), tf32(x.imag.contiguous()))
    if x.dtype != torch.float32:
        raise TypeError(f"tf32 rounds float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

