"""Denormal handling parity (counterpart of mathaudio_tpu/dsp/denormals.py;
math-iir-fir/src/denormals.rs:19-41).

The reference crate installs an FTZ/DAZ guard around sample loops because
x86 denormal arithmetic is ~100x slower. Here the sample loops are tensor
operations, so the guard is the JAX package's documented no-op, kept for
API compatibility with code ported from the reference.
"""

from __future__ import annotations

import contextlib


class ScopedFlushToZero(contextlib.AbstractContextManager):
    """No-op context manager (denormals.rs ScopedFlushToZero parity)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@contextlib.contextmanager
def flush_denormals():
    yield
