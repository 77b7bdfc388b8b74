"""Wall-clock phase spans (counterpart of mathaudio_tpu/utils/profiling.py):
host time, as the reference measures it. For device time use
torch.profiler alongside these.

The port's own layer record (no counterpart in the reference): the hot
paths open named regions (``region``) and count their events (``count``
for host integers, ``tally`` for device tensors, kept by reference and
summed when read). They record exactly while a ``torch.profiler`` session
records (``torch.autograd``'s profiler-enabled flag); otherwise every call
is one flag check. A region opens a ``record_function`` span of its name,
so it lands in the profiler's trace on the device activity's clock, and
takes its own start and end: a CUDA event pair on the current stream
once CUDA is initialised (events from a reused pool, resolved only when
read, so a region adds no sync), else the host clock. ``snapshot()`` gives
per region the calls, the milliseconds between its start and end, and the
self milliseconds (that minus the union of its child regions' intervals);
it synchronises on the recorded events only. Nothing is written out: the
caller reads ``snapshot()`` in process and ``reset()`` clears it.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict

import torch
from torch.autograd.profiler import record_function


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


recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Call:
    """One entry into a region: its name, the index of the region it
    opened inside (-1 at the top), and its start and end stamps (CUDA
    events, or host seconds)."""

    __slots__ = ("name", "parent", "start", "end")

    def __init__(self, name, parent, start):
        self.name, self.parent, self.start, self.end = name, parent, start, None


class _Region:
    __slots__ = ("rec", "name", "span", "index")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.span = record_function(self.name)
        self.span.__enter__()
        self.index = self.rec._open(self.name)

    def __exit__(self, *exc):
        self.rec._close(self.index)
        self.span.__exit__(*exc)
        return False


def _union_ms(spans, lo, hi) -> float:
    """Length of the union of (start, end) spans clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Recorder:
    """Regions, counters and tallies of one process (module notes)."""

    def __init__(self):
        self._free = []  # CUDA events ready for reuse
        self._calls = []
        self.reset()

    def reset(self) -> None:
        """Forget every recorded call, counter and tally."""
        for c in self._calls:
            if not isinstance(c.start, float):
                self._free.append(c.start)
                if c.end is not None:
                    self._free.append(c.end)
        self._calls, self._stack = [], []
        self._counts: Dict[str, int] = {}
        self._tallies: Dict[str, list] = {}

    def region(self, name: str):
        """Context manager: a named region while recording, else nothing."""
        return _Region(self, name) if recording() else _OFF

    def count(self, name: str, n: int = 1) -> None:
        """Add the host integer ``n`` to counter ``name`` while recording."""
        if recording():
            self._counts[name] = self._counts.get(name, 0) + n

    def tally(self, name: str, tensor: torch.Tensor) -> None:
        """Keep ``tensor`` (by reference; no kernel, no sync) for its sum
        under ``name`` while recording."""
        if recording():
            self._tallies.setdefault(name, []).append(tensor)

    def _stamp(self, cuda: bool):
        if not cuda:
            return time.perf_counter()
        ev = self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _open(self, name: str) -> int:
        parent = self._stack[-1] if self._stack else -1
        self._calls.append(_Call(name, parent, self._stamp(torch.cuda.is_initialized())))
        self._stack.append(len(self._calls) - 1)
        return self._stack[-1]

    def _close(self, index: int) -> None:
        call = self._calls[index]
        call.end = self._stamp(not isinstance(call.start, float))
        self._stack.pop()

    def _intervals(self):
        """(start, end) in ms per closed call, each on its own clock (host
        calls from the first host stamp, CUDA calls from the first event)."""
        host = [c.start for c in self._calls if isinstance(c.start, float)]
        events = [c.start for c in self._calls if not isinstance(c.start, float)]
        out = []
        for c in self._calls:
            if c.end is None:
                out.append(None)
            elif isinstance(c.start, float):
                out.append(((c.start - host[0]) * 1e3, (c.end - host[0]) * 1e3))
            else:
                c.end.synchronize()
                out.append((events[0].elapsed_time(c.start), events[0].elapsed_time(c.end)))
        return out

    def snapshot(self) -> dict:
        """{"regions": {name: {"calls", "ms", "self_ms"}}, "counters":
        {name: int}, "tallies": {name: sum}} over what was recorded since
        the last ``reset``; regions still open are left out."""
        spans = self._intervals()
        children = {}
        for i, c in enumerate(self._calls):
            if c.parent >= 0 and spans[i] is not None and (
                    isinstance(c.start, float) == isinstance(self._calls[c.parent].start, float)):
                children.setdefault(c.parent, []).append(spans[i])
        regions = {}
        for i, c in enumerate(self._calls):
            if spans[i] is None:
                continue
            s, e = spans[i]
            r = regions.setdefault(c.name, {"calls": 0, "ms": 0.0, "self_ms": 0.0})
            r["calls"] += 1
            r["ms"] += e - s
            r["self_ms"] += (e - s) - _union_ms(children.get(i, ()), s, e)
        tallies = {name: sum(t.sum().item() for t in ts) for name, ts in self._tallies.items()}
        return {"regions": regions, "counters": dict(self._counts), "tallies": tallies}


RECORDER = Recorder()
region = RECORDER.region
count = RECORDER.count
tally = RECORDER.tally
snapshot = RECORDER.snapshot
reset = RECORDER.reset
