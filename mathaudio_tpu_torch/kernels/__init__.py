"""Hand-written CUDA kernels for Hopper and their build.

Each ``*.cu`` file here exposes a plain C interface. ``load(name)``
compiles ``<name>.cu`` with ``nvcc`` for ``sm_90a`` into
``_build/<name>-<hash>.so`` on first use (the hash covers the source and
the flags, so an edited source rebuilds) and loads it with ctypes. Nothing
is built or imported while this package is imported: the CPU-only test
host imports every module and has no ``nvcc``.

A build failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``<name>.cu`` builds to, keyed by a hash of source + flags."""
    src = KERNEL_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cu`` unless its hashed library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = KERNEL_DIR / f"{name}.cu"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def ptxas_report(name: str) -> list:
    """What ``ptxas -v`` says of every kernel in ``<name>.cu``: one line
    per kernel with its (demangled) name, registers, shared memory and
    spills. Compiles the source once more, to a throw-away cubin."""
    src = KERNEL_DIR / f"{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".cubin", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-cubin", "-Xptxas", "-v", "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
    lines, kernel = [], None
    for line in proc.stderr.splitlines():
        line = line.replace("ptxas info    : ", "").strip()
        if line.startswith("Compiling entry function"):
            kernel = line.split("'")[1]
        elif line.startswith("Function properties for") and kernel is None:
            continue
        elif kernel and ("spill" in line or line.startswith("Used")):
            lines.append(f"{_demangle(kernel)}: {line}")
            if line.startswith("Used"):
                kernel = None
    return lines


def _demangle(symbol: str) -> str:
    found = shutil.which("c++filt")
    if not found:
        return symbol
    out = subprocess.run([found, symbol], capture_output=True, text=True).stdout.strip()
    return out or symbol


def build_all(names) -> list:
    """Build several kernels at once: one nvcc per source, all started
    together. Returns their library paths; raises the first failure."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = [pool.submit(build, name) for name in names]
        return [f.result() for f in futures]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``<name>.cu``'s library, once per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
