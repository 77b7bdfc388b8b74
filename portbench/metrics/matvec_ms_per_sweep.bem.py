"""Device ms per sweep of the dense matrix products (cuBLAS GEMV/GEMM
kernels, by the name fragments below) over the traced sweeps."""

KERNELS = ("gemv", "gemm", "xmma", "cutlass")


def read(rec):
    t = rec["trace"]
    if t is None:
        return None
    busy = sum(e - s for name, s, e in t["kernels"]
               if any(k in name.lower() for k in KERNELS)) / 1e3
    return busy / t["sweeps"] if busy > 0 else None
