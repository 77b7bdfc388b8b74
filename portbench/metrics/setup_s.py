"""Set-up seconds: process start, CUDA start-up, loading the kernels, the
host build and the warm-up sweeps of the cell's own shapes."""


def read(rec):
    return rec["setup_s"]
