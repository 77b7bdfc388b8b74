"""The DIA stencil kernels' share of their roofline over the traced
sweeps: the least time of every launch the program counted, from its
(mode, N, F, x = 0) alone (portbench/work.py), over the device time of the
kernels named below."""

from portbench.work import stencil_bound_s

KERNELS = ("dia_stencil_kernel",)


def read(rec):
    t = rec["trace"]
    if t is None or "dia_launches_by_shape" not in t["counters"]:
        return None
    least = sum(count * stencil_bound_s(mode, n, nf, "complex64", bool(x0))
                for mode, n, nf, x0, count in t["counters"]["dia_launches_by_shape"])
    busy = sum(e - s for name, s, e in t["kernels"] if any(k in name for k in KERNELS)) / 1e6
    if least <= 0 or busy <= 0:
        return None
    return 100.0 * least / busy
