"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles ``csrc/word_cluster.cu`` into a shared library with a
plain C interface, under ``build/mvtrim_tpu_torch/`` at the root of the
checkout, and ``ctypes`` loads it.  The library's name carries a hash of
the source, so an edited ``.cu`` builds anew and an unchanged one is
reused.  Nothing here runs at import: the CPU build never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "word_cluster.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "mvtrim_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# what the last build in this process did: seconds, library path, and the
# compiler's report (ptxas register and shared-memory use); empty when the
# library was already built
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "mvtrim_tpu_torch cannot be built (MVT_SCAN_BACKEND=torch runs the "
        "CPU build)")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmvt_word_cluster_{digest}.so")


def _build(so_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
            f"{proc.stderr.strip()}")
    # rename: a concurrent process sees either no library or a whole one
    os.replace(tmp, so_path)
    build_info.update(seconds=time.perf_counter() - t0, path=so_path,
                      report=proc.stderr.strip())


def load_library():
    """The kernel library, built first if this source has not been."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        fn = lib.mvt_word_cluster_counts
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return lib
