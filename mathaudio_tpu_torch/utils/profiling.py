"""Wall-clock phase spans (counterpart of mathaudio_tpu/utils/profiling.py):
host time, as the reference measures it. For device time use
torch.profiler alongside these."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict


class Timer:
    """Accumulating named-phase timer."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self, file=sys.stderr):
        for name, t in self.phases.items():
            print(f"  {name}: {t:.3f}s", file=file)


@contextlib.contextmanager
def span(name: str, verbose: int = 1, file=sys.stderr):
    """Print '<name>: <t>s' when verbose."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if verbose:
            print(f"{name}: {time.perf_counter() - t0:.2f}s", file=file)
