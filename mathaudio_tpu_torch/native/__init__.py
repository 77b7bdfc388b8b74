"""Host C++ setup kernels (counterpart of mathaudio_tpu/native), built
with ``g++`` at first use and loaded through ctypes.

``kernels.cpp`` holds the ILU(0) factorization (of the FMM near field: a
sequential pointer-chasing pass over a CSR matrix with about a thousand
nonzeros per row at room sizes, which a Python loop would take hours
over; and of the general FEM problem), PMIS coarsening for AMG and greedy
multicoloring for the colored ILU.
``load()`` compiles it into ``_build/libmathaudio_native-<hash>.so`` (the
hash covers the source and the flags, so an edited source rebuilds).
Nothing is built while this package is imported.

A build failure raises; no path falls back to the Python loops, which
stay beside their callers as the plain twins the tests hold the C++
against (``solvers/preconditioners/ilu.py::_ilu0_factor_python`` and
``_greedy_coloring_python``, ``solvers/preconditioners/amg.py::_pmis_python``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "kernels.cpp"
BUILD_DIR = NATIVE_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    """Where ``kernels.cpp`` builds to, keyed by a hash of source + flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmathaudio_native-{digest}.so"


def build() -> Path:
    """Compile ``kernels.cpp`` with g++ unless its hashed library exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native ILU(0) needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ilu0_factor_complex.restype = ctypes.c_int
        lib.ilu0_factor_complex.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.pmis_coarsen.restype = None
        lib.pmis_coarsen.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.greedy_coloring.restype = None
        lib.greedy_coloring.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        _lib = lib
    return _lib


def ilu0_factor_inplace(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray) -> None:
    """ILU(0) of a square CSR matrix with sorted, unique column indices per
    row, in place on its complex128 ``data``."""
    if data.dtype != np.complex128 or not data.flags.c_contiguous or not data.flags.writeable:
        raise ValueError("data must be a writeable, C-contiguous complex128 array")
    indptr64 = np.ascontiguousarray(indptr, np.int64)
    indices32 = np.ascontiguousarray(indices, np.int32)
    n = len(indptr64) - 1
    if indptr64[-1] != len(indices32) or len(data) != len(indices32):
        raise ValueError(f"CSR arrays disagree: indptr ends at {indptr64[-1]}, "
                         f"{len(indices32)} indices, {len(data)} values")
    if len(indices32) and (indices32.min() < 0 or indices32.max() >= n):
        raise ValueError("a column index lies outside the square matrix")
    rc = load().ilu0_factor_complex(indptr64.ctypes.data, indices32.ctypes.data,
                                    data.ctypes.data, n)
    if rc != 0:
        raise RuntimeError(f"ilu0_factor_complex returned {rc}")


def _graph(indptr: np.ndarray, indices: np.ndarray):
    """Contiguous (int64 indptr, int32 indices, n) of a square CSR graph,
    checked before its pointers reach the C++."""
    indptr64 = np.ascontiguousarray(indptr, np.int64)
    indices32 = np.ascontiguousarray(indices, np.int32)
    n = len(indptr64) - 1
    if indptr64[-1] != len(indices32):
        raise ValueError(f"CSR arrays disagree: indptr ends at {indptr64[-1]}, "
                         f"{len(indices32)} indices")
    if len(indices32) and (indices32.min() < 0 or indices32.max() >= n):
        raise ValueError("a column index lies outside the square graph")
    return indptr64, indices32, n


def pmis_coarsen(indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """PMIS coarsening of a symmetric graph with node ``weights``: bool
    is_coarse (N,)."""
    indptr64, indices32, n = _graph(indptr, indices)
    w = np.ascontiguousarray(weights, np.float64)
    if len(w) != n:
        raise ValueError(f"{len(w)} weights for {n} nodes")
    state = np.zeros(n, np.int8)
    load().pmis_coarsen(indptr64.ctypes.data, indices32.ctypes.data, w.ctypes.data,
                        state.ctypes.data, n)
    return state == 1


def greedy_coloring(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Greedy multicoloring of a symmetric graph in row order: int32
    colors (N,)."""
    indptr64, indices32, n = _graph(indptr, indices)
    colors = np.zeros(n, np.int32)
    load().greedy_coloring(indptr64.ctypes.data, indices32.ctypes.data, colors.ctypes.data, n)
    return colors
