"""The dense band matvec's share of its roofline over the traced sweeps:
the band applications the program counted (``gmres.matvecs``), each at
the least time of reading the (F, N, N) complex64 band once (8 F N^2
bytes and 8 F N^2 operations; N = 20 4^s elements of the icosphere of
subdivision s), over the device time of the kernels that
``matvec_ms_per_sweep.bem`` selects by the same name fragments. None
without a trace or the counter."""

from mathaudio_tpu_torch.utils import profiling
from portbench.work import least_seconds

KERNELS = ("gemv", "gemm", "xmma", "cutlass")


def read(rec):
    if rec["trace"] is None or not hasattr(profiling, "snapshot"):
        return None
    matvecs = profiling.snapshot()["counters"].get("gmres.matvecs")
    if not matvecs:
        return None
    n = 20 * 4 ** int(rec["traffic"]["subdivisions"])
    entries = int(rec["traffic"]["lanes"]) * n * n
    least = matvecs * least_seconds(8 * entries, 8 * entries, "complex64")
    busy = sum(e - s for name, s, e in rec["trace"]["kernels"]
               if any(k in name.lower() for k in KERNELS)) / 1e6
    return 100.0 * least / busy if busy > 0 else None
