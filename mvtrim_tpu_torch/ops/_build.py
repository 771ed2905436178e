"""Build, load and launch the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, and ``ctypes`` loads it.  The library lives in
``MVT_COMPILE_CACHE`` where that is set (the directory compiled programs
persist in, shared by processes, as for the JAX package); else in
``build/mvtrim_tpu_torch/`` at the root of the checkout the package sits
in, or in ``~/.cache/mvtrim_tpu/torch`` for an installed package.  The
sources compile in parallel, one ``nvcc`` each, and are linked in one more
step.  The library's name carries a hash of all the sources and of the
headers they include (``csrc/*.cuh``), so an edited, added or removed
file builds anew, and a library already there for these sources is loaded
without ``nvcc``.  Nothing here runs at import: the CPU build never needs
``nvcc``.

    python -m mvtrim_tpu_torch.ops._build [--arch sm_90a]

builds the library for these sources now (an image does so at build time)
and prints its path; ``--arch`` fails unless it is the arch built for.

``launch`` is the one way the wrappers call a kernel's C entry point: bound
once, on the tensor's card and PyTorch's current stream there, raising on a
nonzero CUDA error, and counting the launch on the wrapper.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time

import torch

from ..utils.timing import SPANS

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_ROOT = os.path.dirname(_PKG_DIR)
# the default directory: the checkout's build/, or the user's cache for a
# package installed outside a checkout
BUILD_DIR = (os.path.join(_ROOT, "build", "mvtrim_tpu_torch")
             if os.path.exists(os.path.join(_ROOT, "pyproject.toml"))
             else os.path.expanduser("~/.cache/mvtrim_tpu/torch"))
ARCH = "sm_90a"
ARCH_FLAGS = ["-gencode", f"arch=compute_90a,code={ARCH}"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points of the library and their argument types (every pointer
# and the stream as c_void_p, or ctypes would cut them to 32 bits)
SIGNATURES = {
    # rows, batch, gh, pitch, gw, y_min, y_max, need, counts, motion,
    # device, stream
    "mvt_word_cluster_counts": [_P] + [_I] * 7 + [_P, _P, _I, _P],
    # host_rows, rows, batch, gh, pitch, gw, y_min, y_max, need, counts,
    # motion, host_motion, event, device, stream: a staged batch
    # (models/staging.py) in one call, the rows' copy to the card, the
    # kernel of mvt_word_cluster_counts, the motion's copy back and the event
    "mvt_word_cluster_batch": [_P, _P] + [_I] * 7 + [_P] * 4 + [_I, _P],
    # votes, is_int32, batch, gh, gw, y_min, y_max, thr, need, counts,
    # motion, device, stream
    "mvt_cluster_map_counts": [_P] + [_I] * 8 + [_P, _P, _I, _P],
    # luma, batch, height, width, block, gh, gw, vec, grid, device, stream
    "mvt_sad_block_grid": [_P] + [_I] * 7 + [_P, _I, _P],
    # mvs, mv_counts, batch, m, gh, gw, y_min, y_max, bound, thr, need,
    # shift, scratch, scratch_cells, counts, motion, device, stream
    "mvt_mv_cluster_counts": [_P, _P] + [_I] * 6 + [_L] + [_I] * 3
                             + [_P, _L, _P, _P, _I, _P],
    # batch, gh, gw, y_min, y_max, force_global
    "mvt_mv_cluster_scratch": [_I] * 6,
    # the bench's controls (bench/controls.py)
    # rows, batch, gh, pitch, gw, sums, device, stream
    "mvt_word_stream_control": [_P] + [_I] * 4 + [_P, _I, _P],
    # luma, batch, height, width, block, gh, gw, vec, grid, device, stream
    "mvt_sad_stream_control": [_P] + [_I] * 7 + [_P, _I, _P],
    "mvt_sad_compute_control": [_P] + [_I] * 7 + [_P, _I, _P],
    # mvs, mv_counts, batch, m, sums, device, stream
    "mvt_mv_stream_control": [_P, _P, _I, _I, _P, _I, _P],
    # as mvt_mv_cluster_counts
    "mvt_mv_compute_control": [_P, _P] + [_I] * 6 + [_L] + [_I] * 3
                              + [_P, _L, _P, _P, _I, _P],
    # mvs, mv_counts, sub (or NULL), batch, m, mode, sums, device, stream
    "mvt_mv_capacity_control": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    # mvs, mv_counts, batch, m, gh, gw, y_min, y_max, bound, shift, scratch,
    # scratch_cells, sums, device, stream
    "mvt_mv_votes_control": [_P, _P] + [_I] * 6 + [_L, _I]
                            + [_P, _L, _P, _I, _P],
    # batch, gh, gw, y_min, y_max
    "mvt_mv_votes_scratch": [_I] * 5,
    # mvs, batch, m, gh_p, gw_p, sums, device, stream
    "mvt_mv_matrix_control": [_P] + [_I] * 4 + [_P, _I, _P],
}
# entry points that return long long, not int
RESTYPES = {"mvt_mv_cluster_scratch": ctypes.c_longlong,
            "mvt_mv_votes_scratch": ctypes.c_longlong}

_lock = threading.Lock()
_lib = None
# what the last build in this process did: seconds, library path, and the
# compiler's report (ptxas register and shared-memory use); empty when the
# library was already built
build_info: dict = {}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


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


def build_dir() -> str:
    """Where the library is built and looked for: MVT_COMPILE_CACHE, else
    ``BUILD_DIR``."""
    return os.environ.get("MVT_COMPILE_CACHE") or BUILD_DIR


def library_path() -> str:
    digest = hashlib.sha256()
    for src in sources() + headers():
        digest.update(os.path.basename(src).encode() + b"\0")
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir(),
                        f"libmvt_kernels_{digest.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Start every command at once, wait for all; their stderr, or
    RuntimeError naming the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}) on {cmd[-1]}:\n{err.strip()}")
    return [err.strip() for _, err in outs]


def _build(so_path: str) -> None:
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out_dir = os.path.dirname(so_path)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, os.path.basename(s) + f".{tag}.o")
            for s in srcs]
    t0 = time.perf_counter()
    try:
        reports = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", o, s]
                            for s, o in zip(srcs, objs)])
        tmp = f"{so_path}.{tag}"
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    # rename: a concurrent process sees either no library or a whole one
    os.replace(tmp, so_path)
    build_info.update(seconds=time.perf_counter() - t0, path=so_path,
                      report="\n".join(r for r in reports if r))


def load_library():
    """The kernel library, built first if these sources have not been.
    A library that is there but does not load raises; it is not rebuilt."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = RESTYPES.get(name, ctypes.c_int)
            fn.argtypes = argtypes
        _lib = lib
        return lib


_entries: dict = {}
_count_lock = threading.Lock()


def launch(name: str, counter, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args``, then the index of
    ``device`` (a CUDA device; the C side makes it current only where it is
    not) and PyTorch's current stream on it.  Raises RuntimeError on a
    nonzero CUDA error; else adds one to ``counter.launches`` (and, while
    spans are recorded, to the calling thread's launches)."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries.setdefault(name, getattr(load_library(), name))
    index = device.index
    err = fn(*args, index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    with _count_lock:
        counter.launches += 1
    if SPANS.on:
        SPANS.count_launch()


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Build the kernel library for these sources into "
                    "MVT_COMPILE_CACHE (else the default directory) and "
                    "print its path.")
    ap.add_argument("--arch", default=ARCH,
                    help=f"the arch the caller expects; must be {ARCH}")
    args = ap.parse_args(argv)
    if args.arch != ARCH:
        ap.error(f"--arch {args.arch}: the kernels are built for {ARCH}")
    load_library()
    if build_info:
        print(f"built in {build_info['seconds']:.3f} s", file=sys.stderr)
    print(library_path())
    return 0


if __name__ == "__main__":
    sys.exit(main())
