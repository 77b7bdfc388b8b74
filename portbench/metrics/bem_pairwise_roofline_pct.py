"""The BEM pairwise kernels' share of their roofline over the traced
sweeps: each sweep's whole band assembly (N x N pairs, F wavenumbers, nq
points; inputs read once, planes written once; portbench/work.py) counted
once however many row chunks run, over the device time of the kernels
named below."""

from portbench.work import bem_bound_s

KERNELS = ("bem_pairwise_kernel", "bem_pairwise_rows_kernel")
ELEMENTS_OF_SUBDIVISION = 20


def read(rec):
    t = rec["trace"]
    if t is None:
        return None
    p = rec["traffic"]
    n = ELEMENTS_OF_SUBDIVISION * 4 ** int(p["subdivisions"])
    nq = int(rec["config"]["quad_points"])
    least = t["sweeps"] * bem_bound_s(p["formulation"], n, n, nq, int(p["lanes"]))
    busy = sum(e - s for name, s, e in t["kernels"] if any(k in name for k in KERNELS)) / 1e6
    if busy <= 0:
        return None
    return 100.0 * least / busy
