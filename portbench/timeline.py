"""Reduction of a profiler trace to device busy time, idle share and the
breakdown line: the union of device activity over a window (a frozen
copy of the union ``chip_smoke.py``'s ``profile_run`` takes), the device
operations that took most time, and the longest idle gaps named by what
the host was doing.
"""

from __future__ import annotations


def union_us(spans, lo: float, hi: float) -> float:
    """Length of the union of (start, end) spans clipped to [lo, hi]."""
    busy, cur_s, cur_e = 0.0, None, None
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if end <= start:
            continue
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(spans, lo: float, hi: float):
    """(start, end) intervals of [lo, hi] in which no span is active."""
    out, cur = [], lo
    for start, end in sorted(spans):
        if start > cur:
            out.append((cur, min(start, hi)))
        cur = max(cur, end)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def top_by_name(items, limit: int = 10):
    """[[name, seconds], ...] of the largest sums of (name, seconds)."""
    sums = {}
    for name, sec in items:
        sums[name] = sums.get(name, 0.0) + sec
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:limit]]


def host_at(cpu_ops, t: float, skip=()) -> str:
    """Name of the innermost host operation running at time t (us)."""
    best, best_len = "host (between operations)", None
    for name, start, end in cpu_ops:
        if start <= t <= end and name not in skip:
            if best_len is None or end - start < best_len:
                best, best_len = name, end - start
    return best


def breakdown(kernels, cpu_ops, lo: float, hi: float, skip=()):
    """The ``breakdown`` of a traced window: device operations by total
    seconds, and idle gaps by the host operation under their midpoint."""
    ops = top_by_name((name, (min(e, hi) - max(s, lo)) / 1e6)
                      for name, s, e in kernels if min(e, hi) > max(s, lo))
    cpu_sorted = sorted(cpu_ops, key=lambda op: op[1])
    idle = gaps([(s, e) for _, s, e in kernels], lo, hi)
    named = [(host_at(_around(cpu_sorted, (s + e) / 2), (s + e) / 2, skip), (e - s) / 1e6)
             for s, e in idle]
    return {"device_ops": ops, "idle_gaps": top_by_name(named)}


def _around(cpu_sorted, t: float, depth: int = 4096):
    """The host operations among the last ``depth`` to start before t:
    those that can be the innermost one running at t."""
    lo, hi = 0, len(cpu_sorted)
    while lo < hi:
        mid = (lo + hi) // 2
        if cpu_sorted[mid][1] <= t:
            lo = mid + 1
        else:
            hi = mid
    return cpu_sorted[max(0, lo - depth):lo]
