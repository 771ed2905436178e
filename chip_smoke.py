"""Smoke run of mvtrim_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N] [--times-only]

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version and the NumPy oracle at the geometries the scan paths
meet, drives every ported scan path end to end, and times each kernel
against its plain version and its bound.  Every phase raises on a failure,
so any failure exits nonzero.  The last two lines of standard output are
one JSON line listing the kernels of the paths and the result line
``{"ok": true, "device": {...}}``.

Phase 4 drives ``python -m mvtrim_tpu_torch``'s ``main`` on a synthetic
1080p clip, once per path (bits, words, grids, mv_raw, SAD), and
``tools.tune`` on it (grids, mv_raw and SAD sweeps, with and without
``--device-stats``), when the native host library (FFmpeg's libav*) loads.
Where it does not, the phase says so on its own line and drives the device
half of each path instead, on seeded 1080p data: activity masks (bits,
words), vote grids (grids) and MV fields (mv_raw) through
``MVClusterDetector``, luma through ``SADDetector`` in the pipeline's
cap-sized sub-scans with the carry threaded, each on through merging,
segmentation and the cut decision; and ``tools.tune``'s three routes, with
and without ``--device-stats``, over a stand-in reader that serves the
same data, against the same calls with the CPU build.  Over the same
stand-in reader it drives in both cases: the pipeline's mv_raw workers and
feeder at an MV capacity the fullest frames overflow (their chunks are
re-decoded at a larger capacity and decided on the card); the archive scan
(``parallel.archive.scan_archive_reader``) on the bits and SAD payloads
(SAD in short chunks over two decode workers, whose chunk parts are made
to interleave so that placeholder rows are fed), and on bits again in two
ranks joined by gloo, both on this card, with one rank given fewer chunks
than the other; and ``tune --mesh 1`` on the grids and SAD routes; each
against the CPU build and the NumPy oracle.  The launch counts are set to 0 just before each
path and read just after it; the bits path must also make no host repack
of its masks.  ``tools.doctor`` runs first and must report every CUDA
check passed, a missing libav as a failed check, and its end-to-end check
on the card's backend.

Phase 5 times each kernel against its plain version and its bound: K1 at
1080p B = 750 and 2048 and 4K B = 2048 at both row pitches (the bits as the
scanner packs them, the words payload) beside C1, the same rows streamed
on a launch of its own, where a K1 call's host time goes step by step,
and the feeder's dispatch of one 750-frame chunk.  ``--times-only`` runs
phases 1, 2 and 5.

Phase 6 holds the bench's controls C1-C10 (``mvtrim_tpu_torch/bench/
controls.py``) to their plain versions on the card, exactly, times them
by CUDA graph, and runs ``python -m mvtrim_tpu_torch.bench --quick``'s
main in this process: its last line must be the headline JSON and every
cell must pass its audit.  Its launches, counted from 0 just before it
(a graph's capture counts each launch once), must include every kernel
and control.  C2 is the stream control of K6's launch, C4 the compute
control of K6, C6-C8 K4+K5's launch over all M slots (``mv_bench.py``'s
``ctrl``, ``ctrlsub``, ``ctrlmm``) and C10 the one-hot vote product's
shapes on the tensor cores (``mmctrl``).  C1 (K1's rows, a warp a frame,
every load in flight at once) runs on a launch of its own and is also
held at B = 1 and 3, at batches that leave a CTA short of frames, at 4K
and at 8K's frames of 259,200 B, both pitches, aligned and at a base 1 B
(bits) or 4 B (words) off.  C3 (``ctrl`` by the count), C9 (``noclu``:
K4+K5's vote scatter without the cluster rule) and C5 (K4+K5's whole
rule over frame 0, held for every frame) run on a launch of their own (a
frame to a small CTA, a persistent grid taking the frames in turn), and
are also held at the counts that stress it (``RAGGED_EDGES``: all zero,
one frame at M among zeros, B = 1 and 3, counts above M and negative, an
odd M and a base 8 bytes off, more frames than the grid's CTAs, 8K's
global histogram; C5 at a held count of 0, 1, M, above M and negative,
and at VECTORS_NEEDED 0 and above any cell's votes); each call counts
one launch.  ``--times-only`` also times C1 and C5 at this phase's shapes
(C1 beside ``torch.sum`` of the same bytes) and C3, C5, C9 and K4+K5 at
``RAGGED_TIMING``.  Phase 2 fails unless the compiler's report names
every kernel and ``cuobjdump -sass`` finds IMMA (integer tensor-core)
instructions in C10's kernel.

Phase 7 is the deployment.  7a runs ``python -m mvtrim_tpu_torch.ops._build``
into a fresh MVT_COMPILE_CACHE and then, in a process that cannot reach
``nvcc``, doctor's kernel-library and kernel-cache checks and K1 on the
seeded 1080p masks, exact against its plain version; that process must
build nothing and never look for ``nvcc``.  7b runs the port's
``BatchProcessor`` in watch mode in a process of its own and drops 12
stand-in files into its folder one at a time, alternating an MV camera
(``SeededReader``, 60 s of 1080p at the bits payload) and an all-intra one
(no frame with MVs, so ``MVT_PIPELINE=auto`` sends it to the SAD path, K6
then K3), cut by ``parity/fake_ffmpeg.sh``, which dumps each concat list.
Each list must equal the oracle backend's for the same stand-in; per file
it prints the time from landing to list, host RSS, device reserved memory
and pinned host memory, and fails on growth of 50 MB or more from the
third file on (``bench.soak_watch``'s rule).  The watch path's launches,
counted from 0 in the daemon, must include K1, K6 and K3.

Phase 8 replays real encoder output on the card.  ``mvtrim_tpu_torch/
bench/replay.py`` holds payloads recorded from the native scans of four
synthesized clips (A: 1080p x264 with B-frames and sensor noise, 60 s,
masks, words and vote grids; B: the same camera for 10 s, every raw MV,
most frames past 8,192 of them; C: 4K x264, masks; D: HEVC, no MV side
data, luma).  ``ReplayReader`` stands in for ``native.VideoReader`` (the
probe and every decode worker), and the port's ``ProcessingPipeline``
decides A on the bits, words and grids payloads, B on mv_raw, C on bits
and D under ``MVT_PIPELINE=auto`` (so on the SAD path), cut by
``parity/fake_ffmpeg.sh``.  Each concat list must equal the one the oracle
backend cut the real decode to when the fixture was recorded; B must
re-decode a chunk at an MV capacity above 16,384.  Each run is made twice,
timed and then with CUDA events around each kernel launch, and logs its
wall time, its dispatches and each launch's device time.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mvtrim_tpu_torch import Config, GridGeometry, native, oracle  # noqa: E402
from mvtrim_tpu_torch.bench import audit, controls, replay  # noqa: E402
from mvtrim_tpu_torch.bench import mv as bench_mv  # noqa: E402
from mvtrim_tpu_torch.bench.audit import (  # noqa: E402
    centre_cells, least_time, map_bytes, word_bound)
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector  # noqa: E402
from mvtrim_tpu_torch.models.sad_detector import (  # noqa: E402
    SADDetector, sad_oracle_counts)
from mvtrim_tpu_torch.ops import _build  # noqa: E402
from mvtrim_tpu_torch.ops import cluster as cluster_ops  # noqa: E402
from mvtrim_tpu_torch.ops import mv_vote as mv_ops  # noqa: E402
from mvtrim_tpu_torch.ops import sad as sad_ops  # noqa: E402
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline  # noqa: E402

# name -> (the wrapper whose count shows a launch, source, TPU kernel)
KERNELS = {
    "word_cluster_counts": (cluster_ops.cluster_words_op,
                            "mvtrim_tpu_torch/csrc/word_cluster.cu",
                            "mvtrim_tpu/ops/cluster.py:444"),
    "cluster_map_counts": (cluster_ops.cluster_map_op,
                           "mvtrim_tpu_torch/csrc/cluster_map.cu",
                           "mvtrim_tpu/ops/cluster.py:123"),
    "sad_block_grid": (sad_ops.sad_grid_op,
                       "mvtrim_tpu_torch/csrc/sad_block.cu",
                       "mvtrim_tpu/ops/sad.py:269"),
    "mv_cluster_counts": (mv_ops.mv_cluster_op,
                          "mvtrim_tpu_torch/csrc/mv_cluster.cu",
                          "mvtrim_tpu/ops/mv_vote.py:304,322"),
    # the bench's controls (phase 6), C1-C5
    "word_stream_control": (controls.word_stream_control,
                            "mvtrim_tpu_torch/csrc/bench_controls.cu",
                            "bench.py:369"),
    "sad_stream_control": (controls.sad_stream_control,
                           "mvtrim_tpu_torch/csrc/bench_controls.cu",
                           "benchmarks/sad_bench.py:633"),
    "mv_stream_control": (controls.mv_stream_control,
                          "mvtrim_tpu_torch/csrc/bench_controls.cu",
                          "benchmarks/mv_bench.py:469"),
    "sad_compute_control": (controls.sad_compute_control,
                            "mvtrim_tpu_torch/csrc/sad_block.cu",
                            "benchmarks/sad_bench.py:491,520"),
    "mv_compute_control": (controls.mv_compute_control,
                           "mvtrim_tpu_torch/csrc/bench_controls.cu",
                           "benchmarks/mv_bench.py:469"),
    # C6-C10, mv_bench.py's ctrl, ctrlsub, ctrlmm, noclu and mmctrl
    "mv_capacity_control": (controls.mv_capacity_control,
                            "mvtrim_tpu_torch/csrc/bench_controls.cu",
                            "benchmarks/mv_bench.py:390"),
    "mv_capacity_control_sub": (controls.mv_capacity_control_sub,
                                "mvtrim_tpu_torch/csrc/bench_controls.cu",
                                "benchmarks/mv_bench.py:397"),
    "mv_capacity_control_mm": (controls.mv_capacity_control_mm,
                               "mvtrim_tpu_torch/csrc/bench_controls.cu",
                               "benchmarks/mv_bench.py:400"),
    "mv_votes_control": (controls.mv_votes_control,
                         "mvtrim_tpu_torch/csrc/bench_controls.cu",
                         "benchmarks/mv_bench.py:424"),
    "mv_matrix_control": (controls.mv_matrix_control,
                          "mvtrim_tpu_torch/csrc/bench_controls.cu",
                          "benchmarks/mv_bench.py:408"),
}
# the entry functions of the kernels, as the compiler's report names them
# (names carry the anonymous namespace), and C10's, which must hold IMMA
KERNEL_FUNCTIONS = ("word_cluster_kernel", "cluster_map_kernel",
                    "sad_block_kernel", "sad_block_resident_kernel",
                    "mv_cluster_kernel", "word_bit0_control_kernel",
                    "sad_stream_control_kernel", "mv_stream_control_kernel",
                    "mv_compute_control_kernel",
                    "mv_capacity_control_kernel", "mv_votes_control_kernel",
                    "mv_matrix_control_kernel")
TENSOR_KERNEL = "mv_matrix_control_kernel"
CONTROLS = tuple(controls.CONTROLS)
# path -> the kernels it must launch
PATH_KERNELS = {
    "bits": ("word_cluster_counts",),
    "words": ("word_cluster_counts",),
    "grids": ("cluster_map_counts",),
    "mv_raw": ("mv_cluster_counts",),
    "sad": ("sad_block_grid", "cluster_map_counts"),
    "tune_grids": ("cluster_map_counts",),
    "tune_mv_raw": ("mv_cluster_counts",),
    "tune_sad": ("sad_block_grid", "cluster_map_counts"),
    "mv_raw_overflow": ("mv_cluster_counts",),
    "archive_bits": ("word_cluster_counts",),
    "archive_sad": ("sad_block_grid", "cluster_map_counts"),
    "archive_bits_2rank": ("word_cluster_counts",),
    "tune_grids_mesh": ("cluster_map_counts",),
    "tune_sad_mesh": ("sad_block_grid", "cluster_map_counts"),
    "watch": ("word_cluster_counts", "sad_block_grid", "cluster_map_counts"),
}
# phase 8: the recorded payloads of bench/replay.py's fixtures, each run of
# each fixture a path of its own
REPLAY_PATHS = {
    ("A", "bits"): ("word_cluster_counts",),
    ("A", "words"): ("word_cluster_counts",),
    ("A", "grids"): ("cluster_map_counts",),
    ("B", "mv_raw"): ("mv_cluster_counts",),
    ("C", "bits"): ("word_cluster_counts",),
    ("D", "auto"): ("sad_block_grid", "cluster_map_counts"),
}
PATH_KERNELS.update({f"replay_{fx}_{run}": names
                     for (fx, run), names in REPLAY_PATHS.items()})
# B must re-decode a chunk at an MV capacity above this; the cycles the
# stream spins before each event-timed launch (about 1 ms at the card's
# clocks, well past a launch's 20-100 µs of host enqueue)
REPLAY_OVERFLOW_ABOVE = 16384
HIDE_ENQUEUE_CYCLES = 2_000_000
GEOMETRIES = [  # (width, height, vertical_mask)
    (1920, 1080, 0.05),   # gw=120, not a multiple of 32
    (3840, 2160, 0.05),   # 4K
    (360, 240, 0.0),      # margin 0: rows 0 and gh-1 are centres
    (200, 144, 0.05),     # gw=13, less than one word
    (1024, 576, 0.05),    # gw=64, a multiple of 32
    (512, 2048, 0.0),     # one word per row, margin 0
]
BATCHES = (4096, 1, 777)
# K1: the listed batches and the main path's 750-frame chunk, at both
# pitches, aligned and at a base 1 B (bits) or 4 B (words) off; and frames
# larger than a block's shared memory, which take device-memory reads:
# (width, height, vertical_mask, BLOCK_SHIFT, batches)
WORD_BATCHES = BATCHES + (750,)
WORD_OFFSETS = {"bits": 1, "words": 4}
WORD_LARGE = (7680, 4320, 0.05, 2, (1, 70))   # 259,200 B a frame
VECTORS_NEEDED = (0, 1, 2, 255)
# K3 at the shapes the paths launch it at, and at frames whose rows take
# one-cell loads: (width, height, vertical_mask, batch, dtype, byte offset
# of the base); thresholds THRESHOLDS and, for int32, the SAD bound
MAP_CASES = [
    (1920, 1080, 0.05, 64, "int32", 0),     # the SAD window, 1080p
    (3840, 2160, 0.05, 64, "int32", 0),     # the SAD window, 4K
    (1920, 1080, 0.05, 2048, "uint8", 0),   # grids payload, tune grids
    (200, 144, 0.05, 2048, "uint8", 0),     # 117 B a frame
    (1000, 562, 0.0, 777, "uint8", 0),      # 2,268 B a frame, gw 63
    (360, 240, 0.0, 64, "int32", 0),        # 1,380 B a frame, margin 0
    (1920, 1080, 0.05, 777, "uint8", 1),    # base 1 B past 4-B alignment
    (1920, 1080, 0.05, 64, "int32", 4),     # base 4 B past 16-B alignment
]
THRESHOLDS = (-1, 0, 1, 2, 255, 2 ** 31 - 1)
SAD_GEOMETRIES = [  # (width, height)
    (1920, 1080),   # 1080 = 67*16 + 8: a partial block row
    (3840, 2160),   # 4K: the geometry of the lane-sliced TPU kernel K7
    (320, 240),
    (1000, 562),    # partial blocks on both axes; 4-byte loads
    (3840, 96),     # the K7 geometry of the JAX package's tests
]
SAD_BATCHES = (1, 63, 64)
# the raw-MV kernel: (width, height, capacity M, batches, counts, layout),
# counts "sparse" log-uniform in 1..M or "full" at M, frames 7, 57, ... 0;
# layouts as device_mvs makes them
MV_CASES = [
    (1920, 1080, 8192, (1, 777, 2048), "sparse", "boxed"),
    (1920, 1080, 8192, (777, 2048), "full", "boxed"),
    (1920, 1080, 8192, (777,), "full", "spread"),
    (1920, 1080, 8192, (777,), "full", "hot1"),
    (1920, 1080, 8192, (777,), "sparse", "hot2"),
    (1920, 1080, 3000, (777,), "sparse", "boxed"),   # not a TPU chunk size
    (3840, 2160, 16384, (777,), "sparse", "boxed"),  # 4K, 118 KB of votes
    (7680, 4320, 8192, (64,), "sparse", "boxed"),    # 468 KB: global
]
# tune: MV_THRESHOLD_SQ x VECTORS_NEEDED x CLUSTERS_NEEDED, and the SAD
# route's SAD_THRESHOLD x CLUSTERS_NEEDED
TUNE_THRESHOLDS = (4.0, 16.0, 64.0)
TUNE_VECTORS = (0, 1, 2)
TUNE_CLUSTERS = (1, 2, 4)
TUNE_SAD_THRESHOLDS = (4.0, 12.0, 30.0)
# the seeded MV sweeps' clip (one chunk, the first motion window); the
# seeded SAD sweep's clip and chunks: one 12 s chunk in two
# cap-resumed sub-scans (258 + 42 frames at 1080p), then a short second
# chunk
TUNE_MV_SEC = 20.0
TUNE_SAD_SEC = 14.0
TUNE_SAD_CHUNK_SEC = 12.0
# phase 5: the raw-MV kernel's frames a launch and batches rotated, and its
# cells: (label, geometry, capacity M, counts, layout) as in MV_CASES
MV_TIMING_BATCH = (2048, 3)
MV_TIMING = (("1080p", (1920, 1080), 8192, "sparse", "boxed"),
             ("1080p", (1920, 1080), 8192, "full", "boxed"),
             ("1080p", (1920, 1080), 8192, "full", "spread"),
             ("4K", (3840, 2160), 16384, "sparse", "boxed"),
             ("4K", (3840, 2160), 16384, "full", "boxed"))
# phase 5: frames a launch and device-resident batches (K1, K3); K3 at the
# SAD window on its own: (label, geometry, batches rotated); the SAD window
# and its (label, geometry, windows rotated) cells
TIMING_BATCH = (2048, 32)
# K1: (label, geometry, frames a launch) at the main path's 750-frame chunk
# and the default device_batch; batches rotated to this many bytes
K1_TIMING = (("1080p", (1920, 1080), 750), ("1080p", (1920, 1080), 2048),
             ("4K", (3840, 2160), 2048))
K1_ROTATED_BYTES = 96e6
MAP_WINDOW_TIMING = (("1080p", (1920, 1080), 32), ("4K", (3840, 2160), 8))
SAD_WINDOW = 64
SAD_TIMING = (("1080p", (1920, 1080), 3), ("4K", (3840, 2160), 2))
FPS = 25.0
CLIP_SEC = 60.0
MOTION_WINDOWS = ((5.0, 12.0), (40.0, 44.0))
# the archive paths: seconds of seeded 1080p data (bits, SAD) and frames a
# shard a dispatch; the SAD scan's chunks and decode workers (three chunks
# of 100 frames, each decoded in parts of 64 and 36 frames); the two-rank
# bits scan's chunks (three: rank 0 takes two, rank 1 one, and joins the
# dispatches it has no frames for); the mv_raw overflow path's chunks
ARCHIVE_BITS_SEC = 60.0
ARCHIVE_SAD_SEC = 12.0
ARCHIVE_FPD = 256
ARCHIVE_SAD_CHUNK_SEC = 4.0
ARCHIVE_SAD_WORKERS = 2
ARCHIVE_2RANK_CHUNK_SEC = 20.0
OVERFLOW_CHUNK_SEC = 10.0
RANK_TIMEOUT = 300
# phase 7: the watch daemon's files, alternating an MV camera and an
# all-intra one, and the seconds the daemon may take to start and each
# file to reach its list (the first absorbs the daemon's first CUDA use)
WATCH_FILES = 12
WATCH_MV_SEC = 60.0
WATCH_INTRA_SEC = 10.0
WATCH_TIMEOUT = 90.0


def log(msg: str) -> None:
    print(msg, flush=True)


def random_masks(rng, n: int, geom: GridGeometry):
    """Seeded activity masks: bool [n, gh, gw] and their mvt_scan_bits
    packing uint8 [n, gh, ceil(gw/8)].  Three frames in four have density
    0.3, the fourth 0.0003, so motion is decided both ways."""
    density = np.where(np.arange(n) % 4 == 3, 3e-4, 0.3).astype(np.float32)
    active = rng.random((n, geom.gh, geom.gw),
                        dtype=np.float32) < density[:, None, None]
    return active, np.packbits(active, axis=2, bitorder="little")


def random_votes(rng, n: int, geom: GridGeometry) -> np.ndarray:
    """Seeded uint8 vote grids [n, gh, gw]: votes 0..3 with a few cells at
    254 and 255, so every threshold of VECTORS_NEEDED splits them."""
    v = rng.integers(0, 4, size=(n, geom.gh, geom.gw), dtype=np.uint8)
    top = rng.random(v.shape, dtype=np.float32)
    v[top < 0.05] = 255
    v[(top >= 0.05) & (top < 0.1)] = 254
    return v


def oracle_counts(grids: np.ndarray, geom: GridGeometry,
                  vectors_needed: int = 1) -> np.ndarray:
    return np.concatenate([
        oracle.count_clusters_batch(
            grids[i:i + 512], vectors_needed=vectors_needed,
            y_min=geom.y_min, y_max=geom.y_max)
        for i in range(0, len(grids), 512)])


def near_threshold_luma(rng, n: int, width: int, height: int, block: int,
                        bound: int) -> np.ndarray:
    """uint8 [n, H, W]: frame i+1 differs from frame i by a block SAD of
    exactly bound-1, bound, bound+1 or 0 in each block, partial edge
    blocks included.  A pixel differs by at most 128 with a mixed sign,
    so one sign always stays in 0..255 (a partial block too small to
    reach its target at 128 a pixel stays below it)."""
    ys, xs = np.arange(height), np.arange(width)
    by, bx = ys // block, xs // block
    bh = np.minimum(block, height - by * block)
    bw = np.minimum(block, width - bx * block)
    # rank of each pixel inside the in-frame part of its block: the first
    # `rem` ranks of a block take one more than the rest
    rank = (ys % block)[:, None] * bw[None, :] + (xs % block)[None, :]
    px = bh[:, None] * bw[None, :]
    choices = np.array([bound - 1, bound, bound + 1, 0], np.int64)
    gh, gw = -(-height // block), -(-width // block)
    luma = np.empty((n, height, width), np.uint8)
    luma[0] = rng.integers(40, 216, size=(height, width), dtype=np.uint8)
    for i in range(1, n):
        target = choices[rng.integers(0, 4, size=(gh, gw))]
        t = np.minimum(target[by][:, bx], 128 * px)
        d = (t // px + (rank < t % px)).astype(np.int16)
        sign = rng.integers(0, 2, size=(height, width),
                            dtype=np.int16) * 2 - 1
        prev = luma[i - 1].astype(np.int16)
        cur = prev + sign * d
        luma[i] = np.where((cur < 0) | (cur > 255), prev - sign * d, cur)
    return luma


# --- phase 1 ---

def phase_environment() -> tuple[str, bool]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"driver {driver}; nvcc: {nvcc[-2]}")
    have_pc = shutil.which("pkg-config") is not None
    missing = [p for p in ("libavformat", "libavcodec", "libavutil")
               if not have_pc
               or subprocess.run(["pkg-config", "--exists", p]).returncode]
    try:
        native._load_library()
    except OSError as e:
        log("native host library unavailable: libav development packages "
            f"missing here ({', '.join(missing) or 'none reported'}); "
            f"{str(e).splitlines()[0]}")
        log("phase 4 runs the device half of each path on seeded 1080p "
            "data instead of a decoded clip")
        return card, False
    log("native host library: loaded")
    return card, True


# --- phase 2 ---

def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    log(f"kernel build: {info.get('seconds', 0.0):.3f} s nvcc for "
        f"{len(_build.sources())} sources, "
        f"{time.perf_counter() - t0:.3f} s to build and load "
        f"({os.path.relpath(_build.library_path())})")
    report = info.get("report", "")
    for line in report.splitlines():
        log(f"  {line}")
    if report:
        missing = [k for k in KERNEL_FUNCTIONS if k not in report]
        if missing:
            raise AssertionError(f"the compiler's report names no {missing}")
    sass = tensor_sass(_build.library_path())
    imma = [ln.split("*/")[1].split(";")[0].strip() for ln in sass
            if "IMMA" in ln]
    if not imma:
        raise AssertionError(f"no IMMA instruction in {TENSOR_KERNEL}'s SASS")
    log(f"{TENSOR_KERNEL} SASS: {len(imma)} IMMA instructions of "
        f"{len(sass)} lines, e.g. {imma[0]}")


def tensor_sass(library: str) -> list[str]:
    """The SASS lines of C10's kernel in the built library, by the
    toolkit's cuobjdump (beside nvcc)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                         text=True, check=True).stdout
    lines, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = TENSOR_KERNEL in line
        elif inside:
            lines.append(line)
    if not lines:
        raise AssertionError(f"cuobjdump shows no {TENSOR_KERNEL}")
    return lines


# --- phase 3 ---

def word_payloads(bits: torch.Tensor, geom: GridGeometry) -> dict:
    """The bits on the card and their words payload: payload -> (op,
    tensor)."""
    return {"bits": (cluster_ops.cluster_bits_op, bits),
            "words": (cluster_ops.cluster_words_op,
                      cluster_ops.bits_to_words(bits, geom))}


def phase_correctness_words(rng) -> int:
    """K1 vs plain (on the card, same tensor) vs oracle, exact, at both
    pitches, aligned and misaligned bases, frames in shared memory and
    frames past it.  Returns max |kernel - plain|."""
    worst = 0
    width, height, vm, shift, batches = WORD_LARGE
    cases = [(w, h, Config(vertical_mask=v), WORD_BATCHES)
             for w, h, v in GEOMETRIES]
    cases.append((width, height, Config(vertical_mask=vm, block_shift=shift,
                                        block_size=1 << shift), batches))
    for width, height, cfg, batches in cases:
        geom = GridGeometry.build(width, height, cfg)
        need = oracle.effective_clusters_needed(cfg.clusters_needed)
        for b in batches:
            active, bits = random_masks(rng, b, geom)
            expect = oracle_counts(active.astype(np.uint8), geom)
            payloads = word_payloads(torch.from_numpy(bits).cuda(), geom)
            plain = cluster_ops.word_cluster_counts_plain(
                payloads["words"][1], geom)
            if not np.array_equal(plain.cpu().numpy(), expect):
                raise AssertionError(f"plain != oracle at {width}x{height}")
            for name, (op, t) in payloads.items():
                offset = WORD_OFFSETS[name]
                for base, label in ((t, "aligned"),
                                    (offset_copy(t, offset), "offset")):
                    counts, motion = op(base, geom, cfg.clusters_needed)
                    torch.cuda.synchronize()
                    err = int((counts.to(torch.int64) - plain).abs().max())
                    worst = max(worst, err)
                    if err or not torch.equal(motion, plain >= need):
                        raise AssertionError(
                            f"word_cluster kernel disagrees at "
                            f"{width}x{height} B={b} {name} {label}: "
                            f"{int((counts != plain).sum())} counts differ")
            log(f"word_cluster {width}x{height} vm={cfg.vertical_mask} "
                f"BLOCK_SHIFT={cfg.block_shift} B={b}: kernel == "
                f"plain == oracle at pitches {bits.shape[2]} B (bits) and "
                f"{4 * cluster_ops.word_geometry(geom)[0]} B (words), "
                f"aligned and offset bases (mean "
                f"count {expect.mean():.1f}, motion "
                f"{int((expect >= need).sum())}/{b}; "
                f"{geom.gh * bits.shape[2]} B a bits frame)")
    return worst


def phase_correctness_map(rng) -> int:
    """K3 on uint8 votes at VECTORS_NEEDED 0, 1, 2, 255 and on int32 grids
    at the SAD bound, vs the plain version (on the card, same tensor) and
    the NumPy oracle, exact.  Returns max |kernel-plain|."""
    cfg0 = Config()
    bound = sad_ops.sad_threshold_sum(cfg0.sad_threshold, cfg0.block_size)
    worst = 0
    for width, height, vm in GEOMETRIES:
        cfg = Config(vertical_mask=vm)
        geom = GridGeometry.build(width, height, cfg)
        need = oracle.effective_clusters_needed(cfg.clusters_needed)
        for b in BATCHES:
            votes = random_votes(rng, b, geom)
            grid = rng.integers(0, 2 * bound, size=votes.shape,
                                dtype=np.int32)
            cases = [(votes, vn) for vn in VECTORS_NEEDED] + [(grid, bound)]
            summary = []
            for host, thr in cases:
                dev = torch.from_numpy(host).cuda()
                counts, motion = cluster_ops.cluster_map_op(
                    dev, geom, thr, cfg.clusters_needed)
                plain = cluster_ops.cluster_map_counts_plain(dev, geom, thr)
                torch.cuda.synchronize()
                counts = counts.cpu().numpy()
                motion = motion.cpu().numpy()
                plain = plain.cpu().numpy()
                expect = oracle_counts(host, geom, thr)
                worst = max(worst, int(np.abs(counts.astype(np.int64)
                                              - plain).max(initial=0)))
                ok = (np.array_equal(counts, plain)
                      and np.array_equal(counts, expect)
                      and np.array_equal(motion, expect >= need))
                summary.append(f"{host.dtype}>={thr} mean "
                               f"{expect.mean():.1f}")
                if not ok:
                    raise AssertionError(
                        f"cluster_map kernel disagrees at {width}x{height} "
                        f"B={b} {host.dtype} threshold {thr}: "
                        f"{int((counts != expect).sum())} counts differ")
            log(f"cluster_map {width}x{height} vm={vm} B={b}: kernel == "
                f"plain == oracle at {', '.join(summary)}")
    for case in MAP_CASES:
        worst = max(worst, _check_map_case(rng, case, bound))
    return worst


def _check_map_case(rng, case, bound: int) -> int:
    """One MAP_CASES entry vs the plain version on the same tensor, exact,
    at every threshold; returns max |kernel - plain|."""
    width, height, vm, b, dtype, offset = case
    cfg = Config(vertical_mask=vm)
    geom = GridGeometry.build(width, height, cfg)
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    if dtype == "uint8":
        host = random_votes(rng, b, geom)
        thresholds = THRESHOLDS
    else:
        host = rng.integers(0, 2 * bound, size=(b, geom.gh, geom.gw),
                            dtype=np.int32)
        top = rng.random(host.shape, dtype=np.float32)
        host[top < 0.02] = 2 ** 31 - 1
        host[(top >= 0.02) & (top < 0.04)] = -1
        thresholds = THRESHOLDS + (bound,)
    t = torch.from_numpy(host).cuda()
    if offset:
        t = offset_copy(t, offset)
    worst = 0
    for thr in thresholds:
        counts, motion = cluster_ops.cluster_map_op(t, geom, thr,
                                                    cfg.clusters_needed)
        plain = cluster_ops.cluster_map_counts_plain(t, geom, thr)
        torch.cuda.synchronize()
        err = int((counts.to(torch.int64) - plain).abs().max())
        worst = max(worst, err)
        if err or not torch.equal(motion, plain >= need):
            raise AssertionError(
                f"cluster_map kernel disagrees at {width}x{height} B={b} "
                f"{dtype} offset {offset} threshold {thr}")
    log(f"cluster_map {width}x{height} vm={vm} B={b} {dtype} "
        f"({geom.gh * geom.gw * host.itemsize} B a frame, base offset "
        f"{offset} B): kernel == plain at thresholds {thresholds}")
    return worst


def phase_correctness_sad(rng) -> int:
    """K6 (block SAD, then K3 on its grid) vs the plain version on the
    same tensor, exact, on blocks built to sum to bound-1, bound and
    bound+1; the NumPy oracle where its int64 copy stays small.  Returns
    max |kernel grid - plain grid|."""
    cfg = Config()
    bs = cfg.block_size
    bound = sad_ops.sad_threshold_sum(cfg.sad_threshold, bs)
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    kw = dict(block_size=bs, clusters_needed=cfg.clusters_needed)
    worst = 0
    n = max(SAD_BATCHES) + 1
    for width, height in SAD_GEOMETRIES:
        geom = GridGeometry.build(width, height, cfg)
        luma = near_threshold_luma(rng, n, width, height, bs, bound)
        for b in SAD_BATCHES:
            host = luma[n - b - 1:]
            dev = torch.from_numpy(host).cuda()
            variants = [("aligned", dev)]
            if b == 63:
                # a base address off 16 bytes takes narrower loads
                buf = torch.empty(dev.numel() + 1, dtype=torch.uint8,
                                  device=dev.device)
                variants.append(("offset by 1 byte",
                                 buf[1:].view(dev.shape).copy_(dev)))
            plain_grid = sad_ops.sad_block_grid_plain(dev, bs)
            plain_counts = cluster_ops.cluster_map_counts_plain(
                plain_grid, geom, bound)
            near = [int((plain_grid == bound + k).sum()) for k in (-1, 0, 1)]
            for name, t in variants:
                grid = sad_ops._launch_grid(t, geom, bs)
                counts, motion = sad_ops.sad_op(
                    t, geom, sad_threshold=cfg.sad_threshold, **kw)
                torch.cuda.synchronize()
                err = int((grid.to(torch.int64) - plain_grid).abs().max())
                worst = max(worst, err)
                ok = (err == 0 and torch.equal(counts, plain_counts)
                      and torch.equal(motion, plain_counts >= need))
                checked = "plain"
                if width * height <= 320 * 240 or b == 1:
                    expect = sad_oracle_counts(
                        host, geom, sad_threshold=cfg.sad_threshold,
                        block_size=bs)
                    ok = ok and np.array_equal(counts.cpu().numpy(), expect)
                    checked = "plain == oracle"
                log(f"sad_block {width}x{height} B={b} ({name}, "
                    f"{sad_ops._vector_width(t, bs)}-byte loads): kernel == "
                    f"{checked}: {ok} (max |grid diff| {err}; blocks at "
                    f"bound-1/bound/bound+1 {near}; mean count "
                    f"{plain_counts.float().mean():.1f})")
                if not ok:
                    raise AssertionError(
                        f"sad_block kernel disagrees at {width}x{height} "
                        f"B={b} ({name})")
        # MVT_SAD_THRESHOLD=0: every block active, off-grid neighbours too
        dev = torch.from_numpy(luma[:2]).cuda()
        zero = sad_ops.sad_op(dev, geom, sad_threshold=0.0, **kw)[0]
        plain = cluster_ops.cluster_map_counts_plain(
            sad_ops.sad_block_grid_plain(dev, bs), geom, 0)
        torch.cuda.synchronize()
        if not torch.equal(zero, plain):
            raise AssertionError(f"sad threshold 0 at {width}x{height}: "
                                 f"{zero.tolist()} != {plain.tolist()}")
    return worst


def device_mvs(gen, counts: torch.Tensor, m: int, width: int,
               height: int, layout: str = "boxed") -> torch.Tensor:
    """Seeded MV fields int16 [B, m, 4] on the card, displacements up to 8.
    ``boxed``: dst over the frame and 32 pixels past each edge (negative
    dst included), every third MV in a 128x96 box of its frame (48 cells),
    so cells collect several votes and clusters form; ``spread``: dst
    uniform over the frame, a cell collecting about one vote at M = 8192;
    ``hot1`` / ``hot2``: every MV in one cell, or in two neighbouring
    cells, of its frame.  Rows past a frame's count hold noise the kernel
    must not read."""
    b = counts.numel()
    dev = counts.device

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    margin = 0 if layout == "spread" else 32
    dst_x = ints(-margin, width + margin, (b, m))
    dst_y = ints(-margin, height + margin, (b, m))
    if layout == "boxed":
        boxed = torch.arange(m, device=dev) % 3 == 0
        bx, by = ints(0, width - 128, (b, 1)), ints(0, height - 96, (b, 1))
        dst_x = torch.where(boxed, bx + ints(0, 128, (b, m)), dst_x)
        dst_y = torch.where(boxed, by + ints(0, 96, (b, m)), dst_y)
    elif layout in ("hot1", "hot2"):
        # a cell of the centre window (16-pixel cells), per frame
        cx = ints(1, width // 16 - 2, (b, 1))
        cy = ints(height // 64, height // 16 - height // 64, (b, 1))
        second = torch.arange(m, device=dev) % 2 if layout == "hot2" else 0
        dst_x = (cx + second) * 16 + ints(0, 16, (b, m))
        dst_y = cy * 16 + ints(0, 16, (b, m))
    src_x, src_y = dst_x - ints(-8, 9, (b, m)), dst_y - ints(-8, 9, (b, m))
    return torch.stack([dst_x, dst_y, src_x, src_y], dim=2).to(torch.int16)


def extreme_mvs(m: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Two frames whose magnitudes wrap int32: frame 0 holds MVs at dst =
    32767, src = -32768 on both axes; frame 1 holds 3x3 cells of in-grid
    MVs with src = -32768 on both axes (|d|^2 passes 2^31 and wraps
    negative, so they drop out) beside 3x3 cells of ordinary ones."""
    mvs = torch.zeros((2, m, 4), dtype=torch.int16)
    mvs[0, :] = torch.tensor([32767, 32767, -32768, -32768])
    k = 0
    for cy in range(3, 6):
        for cx in range(3, 6):
            mvs[1, k] = torch.tensor([cx << 4, cy << 4, -32768, -32768])
            mvs[1, k + 1] = torch.tensor([(cx + 20) << 4, cy << 4, 0, 0])
            k += 2
    counts = torch.tensor([m, k], dtype=torch.int32)
    return mvs.to(device), counts.to(device)


def _check_mv(mvs, counts, geom, vn, label, global_histogram=None) -> int:
    """One launch of the raw-MV kernel vs its plain version on the same
    tensors, exact; returns max |kernel - plain|."""
    cfg = Config()
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    got, motion = mv_ops.mv_cluster_op(
        mvs, counts, geom, bound, vn, cfg.clusters_needed, cfg.block_shift,
        global_histogram=global_histogram)
    plain = mv_ops.mv_cluster_counts_plain(mvs, counts, geom, bound, vn,
                                           cfg.block_shift)
    torch.cuda.synchronize()
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    err = int((got.to(torch.int64) - plain).abs().max()) if len(got) else 0
    if not (err == 0 and torch.equal(motion, (plain >= need)
                                      & (counts > 0))):
        raise AssertionError(f"mv_cluster kernel disagrees: {label} "
                             f"VECTORS_NEEDED={vn}")
    return err


def phase_correctness_mv(seed: int) -> int:
    """The raw-MV kernel (K4+K5) vs its plain version on the card, exact,
    at every MV_CASES case and VECTORS_NEEDED 0, 1, 2, 255, the
    global-histogram variant forced at 1080p once, and the int16-extreme
    frames; a few frames also against the NumPy oracle.  Returns max
    |kernel - plain|."""
    cfg = Config()
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    worst = 0
    for width, height, m, batches, mode, layout in MV_CASES:
        geom = GridGeometry.build(width, height, cfg)
        glob = mv_ops.uses_global_histogram(geom, torch.device("cuda"))
        for b in batches:
            if mode == "full":
                counts = torch.full((b,), m, dtype=torch.int32)
            else:
                u = torch.rand((b,), generator=gen, device="cuda").cpu()
                counts = torch.exp(u * math.log(m)).to(torch.int32)
            counts[7::50] = 0
            counts = counts.cuda()
            mvs = device_mvs(gen, counts, m, width, height, layout)
            for vn in VECTORS_NEEDED:
                worst = max(worst, _check_mv(
                    mvs, counts, geom, vn,
                    f"{width}x{height} M={m} B={b} {mode} {layout}"))
            forced = ""
            if ((width, height, m, b, mode, layout)
                    == (1920, 1080, 8192, 777, "sparse", "boxed")):
                worst = max(worst, _check_mv(mvs, counts, geom, 2,
                                             "global histogram at 1080p",
                                             global_histogram=True))
                forced = "; global-histogram variant forced: equal"
                sub = mvs[:6].cpu().numpy()
                host = counts[:6].cpu().numpy()
                ours = mv_ops.mv_cluster_op(
                    mvs[:6], counts[:6], geom,
                    mv_ops.threshold_bound(cfg.mv_threshold_sq),
                    cfg.vectors_needed, cfg.clusters_needed,
                    cfg.block_shift)[1].cpu().numpy()
                expect = [oracle.check_frame(
                    sub[i, :host[i]], geom.gw, geom.gh,
                    threshold_sq=cfg.mv_threshold_sq,
                    block_shift=cfg.block_shift, y_min=geom.y_min,
                    y_max=geom.y_max, vectors_needed=cfg.vectors_needed,
                    clusters_needed=cfg.clusters_needed) for i in range(6)]
                if not np.array_equal(ours, expect):
                    raise AssertionError("mv_cluster kernel disagrees with "
                                         "the oracle at 1080p")
                forced += "; 6 frames == oracle"
            log(f"mv_cluster {width}x{height} M={m} B={b} {mode} {layout} "
                f"({'global' if glob else 'shared'} histograms, counts "
                f"{int(counts.min())}..{int(counts.max())}, mean "
                f"{counts.float().mean():.1f}): kernel == plain at "
                f"VECTORS_NEEDED {VECTORS_NEEDED}{forced}")
            del mvs
    geom = GridGeometry.build(1920, 1080, cfg)
    mvs, counts = extreme_mvs(64, "cuda")
    for vn in VECTORS_NEEDED:
        worst = max(worst, _check_mv(mvs, counts, geom, vn, "int16 extremes"))
    votes = mv_ops.mv_votes_plain(mvs, counts, geom, 16, cfg.block_shift)
    if int(votes.sum()) != 9:
        raise AssertionError("the wrapped magnitudes were not dropped")
    log(f"mv_cluster int16 extremes (dst 32767, src -32768; in-grid src "
        f"-32768): kernel == plain at VECTORS_NEEDED {VECTORS_NEEDED}, "
        f"{int(votes.sum())} votes (the wrapped MVs drop out)")
    torch.cuda.empty_cache()
    return worst


# --- phase 4 ---

def _segments_text(segments) -> list[tuple[float, float]]:
    return [(s.start, s.end) for s in segments]


def _decide(motion_ts, cfg: Config):
    ts = oracle.merge_timestamps(motion_ts)
    segments = oracle.segments_from_timestamps(
        ts, max_gap_sec=cfg.max_gap_sec, padding_sec=cfg.padding_sec,
        duration=CLIP_SEC)
    return oracle.decide_cut(segments, CLIP_SEC, cfg.min_savings_pct)


def _check_windows(cut, cfg: Config, last: float, name: str) -> None:
    """The motion windows, padded by PADDING_SEC, are what a cut keeps;
    a window's last motion frame lies ``last`` seconds after its end."""
    is_cut, segments = cut
    if not is_cut or len(segments) != len(MOTION_WINDOWS):
        raise AssertionError(f"{name}: unexpected cut {cut}")
    for (lo, hi), seg in zip(MOTION_WINDOWS, segments):
        if not (abs(seg.start - (lo - cfg.padding_sec)) < 0.02
                and abs(seg.end - (hi + last + cfg.padding_sec)) < 0.02):
            raise AssertionError(f"{name}: segment {seg} does not match "
                                 f"the window {lo}-{hi}")


def synthetic_masks(seed: int, geom: GridGeometry):
    """A 60 s, 25 fps 1080p scan's activity masks: isolated noise cells
    (never 4-adjacent, so never a cluster) in every frame, plus a moving
    blob inside MOTION_WINDOWS.  Returns (active bool, pts)."""
    rng = np.random.default_rng(seed)
    n = int(CLIP_SEC * FPS)
    pts = np.arange(n) / FPS
    active = np.zeros((n, geom.gh, geom.gw), bool)
    lattice = np.zeros((geom.gh, geom.gw), bool)
    lattice[::2, ::2] = True
    active[:] = lattice & (rng.random((n, geom.gh, geom.gw)) < 0.02)
    for lo, hi in MOTION_WINDOWS:
        for i in np.nonzero((pts >= lo) & (pts < hi))[0]:
            x = 4 + int(i * 0.8) % (geom.gw - 20)
            y = geom.gh // 3
            active[i, y:y + 10, x:x + 12] |= rng.random((10, 12)) < 0.7
    return active, pts


def synthetic_votes(seed: int, geom: GridGeometry, need: int):
    """The same scan as uint8 vote grids: the masks' active cells hold
    votes need..need+5, and a third of the other cells hold votes below
    ``need`` (MVs that fall short of the threshold, never a cluster)."""
    rng = np.random.default_rng(seed + 1)
    active, pts = synthetic_masks(seed, geom)
    votes = np.where(rng.random(active.shape, dtype=np.float32) < 0.33,
                     rng.integers(0, max(1, need), size=active.shape,
                                  dtype=np.uint8), 0).astype(np.uint8)
    votes[active] = rng.integers(need, need + 6, size=int(active.sum()),
                                 dtype=np.uint8)
    return votes, pts


def _scan_mv(detector: MVClusterDetector, payload: str, data, pts):
    """The pipeline's feeder over 30 s chunks: dispatch every chunk, then
    resolve in order."""
    chunk = int(Config().chunk_duration_sec * FPS)
    pending = []
    for lo in range(0, len(pts), chunk):
        part = data[lo:lo + chunk]
        if payload == "bits":
            resolve = detector.scan_bits_async(part)
        elif payload == "words":
            resolve = detector.scan_words_async(part)
        else:
            resolve = detector.scan_votes_async(part)
        pending.append((pts[lo:lo + chunk], resolve))
    motion_ts = []
    for p, resolve in pending:
        motion_ts.extend(p[resolve()].tolist())
    return motion_ts


def counting_repacks(run):
    """run() with every call of repack_bits_words counted: (its result,
    the calls)."""
    calls = []
    real = cluster_ops.repack_bits_words

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    cluster_ops.repack_bits_words = counting
    try:
        return run(), len(calls)
    finally:
        cluster_ops.repack_bits_words = real


def check_no_repack(calls: int) -> None:
    log(f"bits path: repack_bits_words called {calls} times on its feeder")
    if calls:
        raise AssertionError("the bits path repacked its masks on the host")


def mv_path(seed: int, payload: str):
    """Seeded 1080p data of one MV payload and its oracle-backend result;
    returns the run that drives the CUDA detector over it."""
    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    if payload == "grids":
        data, pts = synthetic_votes(seed, geom, cfg.vectors_needed)
    else:
        active, pts = synthetic_masks(seed, geom)
        data = np.packbits(active, axis=2, bitorder="little")
        if payload == "words":  # as native mvt_scan_words emits them
            data = cluster_ops.repack_bits_words(data, geom)
    ref = MVClusterDetector(1920, 1080, Config(scan_backend="oracle"))
    ref_ts = _scan_mv(ref, payload, data, pts)
    ref_cut = _decide(ref_ts, cfg)
    _check_windows(ref_cut, cfg, -1 / FPS, f"{payload} oracle")

    def run() -> dict:
        det = MVClusterDetector(1920, 1080, cfg)  # auto -> cuda
        assert det.backend == "cuda", det.backend
        t0 = time.perf_counter()
        motion_ts, repacks = counting_repacks(
            lambda: _scan_mv(det, payload, data, pts))
        scan_s = time.perf_counter() - t0
        if payload == "bits":
            check_no_repack(repacks)
        t0 = time.perf_counter()
        is_cut, segments = _decide(motion_ts, cfg)
        decide_s = time.perf_counter() - t0
        same = (motion_ts == ref_ts and is_cut == ref_cut[0]
                and segments == ref_cut[1])
        log(f"e2e {payload} 1080p {len(pts)} frames: {len(motion_ts)} "
            f"motion frames, cut={is_cut}, segments "
            f"{_segments_text(segments)}; identical to the oracle backend: "
            f"{same}; scan {scan_s * 1e3:.3f} ms, merge+segment+decide "
            f"{decide_s * 1e3:.3f} ms")
        if not same:
            raise AssertionError(f"{payload}: differs from the oracle "
                                 "backend")
        return {"scan_ms": scan_s * 1e3, "decide_ms": decide_s * 1e3}

    return run


class LumaClip:
    """A seeded 60 s, 25 fps luma clip: a static textured background, +-2
    sensor noise on every frame, and a bright 200x120 box moving 8 pixels
    a frame inside MOTION_WINDOWS."""

    def __init__(self, seed: int, width: int, height: int):
        rng = np.random.default_rng(seed)
        self.width, self.height = width, height
        self.background = rng.integers(30, 200, size=(height, width),
                                       dtype=np.int16)
        # seven noise planes, cycled: consecutive frames never share one
        self.noise = rng.integers(-2, 3, size=(7, height, width),
                                  dtype=np.int16)
        self.pts = np.arange(int(CLIP_SEC * FPS)) / FPS

    def frames(self, lo: int, hi: int) -> np.ndarray:
        out = np.empty((hi - lo, self.height, self.width), np.uint8)
        y = self.height * 2 // 5
        for k, i in enumerate(range(lo, hi)):
            f = self.background + self.noise[i % 7]
            if any(a <= self.pts[i] < b for a, b in MOTION_WINDOWS):
                x = 100 + (8 * i) % (self.width - 400)
                f[y:y + 120, x:x + 200] = 255
            np.clip(f, 0, 255, out=f)
            out[k] = f
        return out


def sad_sub_scans(cfg: Config, width: int, height: int, n: int):
    """(lo, hi, threads_carry) of each native scan call the pipeline would
    make over n frames: 30 s chunks, cut into sub-scans at the SAD frame
    cap, the carry threaded inside a chunk and not across chunks."""
    pipe = ProcessingPipeline("", "", cfg=cfg)
    n_threads = pipe._scan_thread_count(
        max(1, math.ceil(CLIP_SEC / cfg.chunk_duration_sec)))
    cap = max(16, (512 * 1024 * 1024) // (width * height) // n_threads)
    chunk = int(cfg.chunk_duration_sec * FPS)
    max_frames = min(cap, math.ceil(cfg.chunk_duration_sec * FPS) + 64)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        for lo in range(c0, c1, max_frames):
            yield lo, min(lo + max_frames, c1), lo > c0


def sad_path(seed: int):
    """Seeded 1080p luma through SADDetector (CUDA) sub-scan by sub-scan,
    each held against SADDetector(torch) on the CPU on the same frames."""
    cfg = Config()
    width, height = 1920, 1080

    def run() -> dict:
        clip = LumaClip(seed, width, height)
        det = SADDetector(width, height, cfg)  # auto -> cuda
        assert det.backend == "cuda", det.backend
        ref = SADDetector(width, height, Config(scan_backend="torch"))
        motion_ts, ref_ts, calls = [], [], 0
        scan_s = 0.0
        carry = None
        for lo, hi, threaded in sad_sub_scans(cfg, width, height,
                                              len(clip.pts)):
            frames = clip.frames(lo, hi)
            carry = carry if threaded else None
            t0 = time.perf_counter()
            motion = det.scan_luma(frames, carry=carry)
            scan_s += time.perf_counter() - t0
            expect = ref.scan_luma(frames, carry=carry)
            if not np.array_equal(motion, expect):
                raise AssertionError(
                    f"sad: frames {lo}-{hi} differ from the plain build")
            motion_ts.extend(clip.pts[lo:hi][motion].tolist())
            ref_ts.extend(clip.pts[lo:hi][expect].tolist())
            carry = frames[-1].copy()
            calls += 1
        t0 = time.perf_counter()
        cut = _decide(motion_ts, cfg)
        decide_s = time.perf_counter() - t0
        same = motion_ts == ref_ts and cut == _decide(ref_ts, cfg)
        log(f"e2e sad 1080p {len(clip.pts)} frames in {calls} sub-scans: "
            f"{len(motion_ts)} motion frames, cut={cut[0]}, segments "
            f"{_segments_text(cut[1])}; identical to SADDetector(torch): "
            f"{same}; scan {scan_s * 1e3:.3f} ms, merge+segment+decide "
            f"{decide_s * 1e3:.3f} ms")
        if not same:
            raise AssertionError("sad: differs from the plain build")
        _check_windows(cut, cfg, 0.0, "sad")
        return {"scan_ms": scan_s * 1e3, "decide_ms": decide_s * 1e3}

    return run


def synthetic_mvs(seed: int, geom: GridGeometry, cfg: Config):
    """The same scan as raw MV fields int16 [N, M, 4] + counts [N]: each
    vote of ``synthetic_votes`` becomes an MV landing in its cell with a
    displacement of 3..8 on each axis (|d|^2 18..128, kept at the
    default MV_THRESHOLD_SQ), beside 150 MVs a frame with |d|^2 <= 2 and
    20 whose dst lies above the frame, which no threshold keeps.  Every
    40th frame outside the motion windows carries no MV side data
    (count 0).  Returns (mvs, counts, pts)."""
    rng = np.random.default_rng(seed + 3)
    votes, pts = synthetic_votes(seed, geom, cfg.vectors_needed)
    n, m, shift = len(pts), cfg.mv_capacity, cfg.block_shift
    in_window = np.zeros(n, bool)
    for lo, hi in MOTION_WINDOWS:
        in_window |= (pts >= lo - 1) & (pts < hi + 1)
    side_less = (np.arange(n) % 40 == 7) & ~in_window
    votes[side_less] = 0
    per_frame = votes.reshape(n, -1).sum(axis=1, dtype=np.int64)
    counts = np.where(side_less, 0, per_frame + 170).astype(np.int32)
    if counts.max() > m:
        raise AssertionError(f"synthetic frames need {counts.max()} > {m}")
    mvs = np.zeros((n, m, 4), np.int16)
    # kept MVs first: one per vote, frame by frame
    cell = np.repeat(np.arange(votes.size), votes.ravel().astype(np.int64))
    frame, within = np.divmod(cell, geom.gh * geom.gw)
    k = np.arange(cell.size) - np.repeat(
        np.concatenate([[0], np.cumsum(per_frame)[:-1]]), per_frame)
    gy, gx = np.divmod(within, geom.gw)
    dst = np.stack([(gx << shift) + rng.integers(0, 1 << shift, cell.size),
                    (gy << shift) + rng.integers(0, 1 << shift, cell.size)],
                   1)
    disp = rng.integers(3, 9, size=(cell.size, 2)) * rng.choice(
        [-1, 1], size=(cell.size, 2))
    mvs[frame, k] = np.concatenate([dst, dst - disp], 1)
    # then the MVs no threshold >= 4 keeps
    rows = np.nonzero(~side_less)[0]
    for i in rows:
        c0 = int(per_frame[i])
        noise = rng.integers(0, [geom.gw << shift, geom.gh << shift],
                             size=(170, 2))
        noise[150:, 1] = -rng.integers(17, 200, size=20)
        mvs[i, c0:c0 + 170] = np.concatenate(
            [noise, noise - rng.integers(-1, 2, size=(170, 2))], 1)
    return mvs, counts, pts


def _scan_raw(detector: MVClusterDetector, mvs, counts, pts):
    """The pipeline's feeder over 30 s chunks of raw MV fields."""
    chunk = int(Config().chunk_duration_sec * FPS)
    pending = [(pts[lo:lo + chunk], detector.scan_raw_mvs_async(
        mvs[lo:lo + chunk], counts[lo:lo + chunk]))
        for lo in range(0, len(pts), chunk)]
    motion_ts = []
    for p, resolve in pending:
        motion_ts.extend(p[resolve()].tolist())
    return motion_ts


@functools.lru_cache(maxsize=1)
def mv_data(seed: int):
    """synthetic_mvs at 1080p, made once per run."""
    cfg = Config()
    return synthetic_mvs(seed, GridGeometry.build(1920, 1080, cfg), cfg)


@functools.lru_cache(maxsize=1)
def mv_oracle_ts(seed: int) -> list:
    """The oracle backend's motion timestamps over mv_data (oracle.
    check_frame per frame), made once per run."""
    mvs, counts, pts = mv_data(seed)
    t0 = time.perf_counter()
    ref = MVClusterDetector(1920, 1080, Config(scan_backend="oracle"))
    ref_ts = _scan_raw(ref, mvs, counts, pts)
    log(f"mv_raw oracle reference: {len(pts)} frames, mean "
        f"{counts.mean():.1f} MVs a frame (most {counts.max()}), in "
        f"{time.perf_counter() - t0:.3f} s")
    return ref_ts


def mv_raw_path(seed: int):
    """Seeded 1080p MV fields through MVClusterDetector.scan_raw_mvs_async
    on the card, held against the oracle backend (oracle.check_frame per
    frame)."""
    cfg = Config()
    mvs, counts, pts = mv_data(seed)
    ref_ts = mv_oracle_ts(seed)
    ref_cut = _decide(ref_ts, cfg)
    _check_windows(ref_cut, cfg, -1 / FPS, "mv_raw oracle")

    def run() -> dict:
        det = MVClusterDetector(1920, 1080, cfg)  # auto -> cuda
        assert det.backend == "cuda", det.backend
        t0 = time.perf_counter()
        motion_ts = _scan_raw(det, mvs, counts, pts)
        scan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        is_cut, segments = _decide(motion_ts, cfg)
        decide_s = time.perf_counter() - t0
        same = (motion_ts == ref_ts and is_cut == ref_cut[0]
                and segments == ref_cut[1])
        log(f"e2e mv_raw 1080p {len(pts)} frames (M={mvs.shape[1]}, "
            f"{mvs.nbytes / 1e6:.1f} MB of int16 fields): {len(motion_ts)} "
            f"motion frames, cut={is_cut}, segments "
            f"{_segments_text(segments)}; identical to the oracle backend: "
            f"{same}; scan {scan_s * 1e3:.3f} ms, merge+segment+decide "
            f"{decide_s * 1e3:.3f} ms")
        if not same:
            raise AssertionError("mv_raw: differs from the oracle backend")
        return {"scan_ms": scan_s * 1e3, "decide_ms": decide_s * 1e3}

    return run


@functools.lru_cache(maxsize=1)
def bits_data(seed: int) -> np.ndarray:
    """synthetic_masks at 1080p as the native scanner packs them: uint8
    [N, gh, ceil(gw/8)], made once per run."""
    active, _ = synthetic_masks(seed, GridGeometry.build(1920, 1080,
                                                         Config()))
    return np.packbits(active, axis=2, bitorder="little")


class SeededReader:
    """A stand-in for ``native.VideoReader`` over the seeded 1080p data,
    where libav does not load.  ``scan_bits`` serves ``bits_data``'s
    masks, ``scan_mvs`` ``mv_data``'s fields (a frame past ``max_mv``
    truncated, its count negated, as the native scan marks an overflow),
    ``scan_grids_multi`` the vote grids the native scatter makes of them
    (uint8, saturating at 255) and ``scan_luma`` ``LumaClip``'s frames.
    Each scan serves the frames of [start, end), at most ``max_frames``,
    and with ``resume`` goes on after the last frame it served; a
    ``timing`` counts the frames that carry MV side data, as the native
    scans do."""

    def __init__(self, seed: int, seconds: float):
        self.seed = seed
        self.width, self.height, self.fps = 1920, 1080, FPS
        self.duration = seconds
        self.pts = np.arange(int(seconds * FPS)) / FPS
        self.geom = GridGeometry.build(1920, 1080, Config())
        self.luma = None
        self.next = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        pass

    def _range(self, start, end, frame_skip, max_frames, resume):
        if frame_skip != 1:
            raise AssertionError(f"frame_skip {frame_skip}: not served")
        lo = self.next if resume else int(np.searchsorted(self.pts, start))
        hi = min(lo + max_frames, int(np.searchsorted(self.pts, end)))
        self.next = hi
        return lo, hi

    def _geometry(self, gw, gh, y_min, y_max) -> None:
        g = self.geom
        if (gw, gh, y_min, y_max) != (g.gw, g.gh, g.y_min, g.y_max):
            raise AssertionError("the scan asked for another grid")

    def scan_bits(self, start, end, *, threshold_sq, block_shift, gw, gh,
                  y_min, y_max, vectors_needed, frame_skip=1,
                  max_frames=4096, timing=None, resume=False):
        self._geometry(gw, gh, y_min, y_max)
        lo, hi = self._range(start, end, frame_skip, max_frames, resume)
        if timing is not None:
            timing.frames_with_mvs += hi - lo
        return bits_data(self.seed)[lo:hi], self.pts[lo:hi]

    def scan_mvs(self, start, end, *, frame_skip=1, max_frames=4096,
                 max_mv=8192, timing=None, resume=False):
        lo, hi = self._range(start, end, frame_skip, max_frames, resume)
        mvs, counts, pts = mv_data(self.seed)
        out = np.zeros((hi - lo, max_mv, 4), np.int16)
        m = min(max_mv, mvs.shape[1])
        out[:, :m] = mvs[lo:hi, :m]
        c = counts[lo:hi]
        if timing is not None:
            timing.frames_with_mvs += int((c != 0).sum())
        return out, np.where(c > max_mv, -c, c).astype(np.int32), pts[lo:hi]

    def scan_grids_multi(self, start, end, *, thresholds_sq, block_shift,
                         gw, gh, y_min, y_max, frame_skip=1,
                         max_frames=4096, resume=False):
        g = self.geom
        self._geometry(gw, gh, y_min, y_max)
        lo, hi = self._range(start, end, frame_skip, max_frames, resume)
        mvs, counts, pts = mv_data(self.seed)
        fields = torch.from_numpy(mvs[lo:hi])
        cnts = torch.from_numpy(counts[lo:hi])
        grids = [mv_ops.mv_votes_plain(
            fields, cnts, g, mv_ops.threshold_bound(t), block_shift)
            .clamp_(max=255).to(torch.uint8).numpy() for t in thresholds_sq]
        return np.stack(grids, axis=1), pts[lo:hi], counts[lo:hi] > 0

    def scan_luma(self, start, end, *, frame_skip=1, max_frames=256,
                  timing=None, resume=False):
        lo, hi = self._range(start, end, frame_skip, max_frames, resume)
        if self.luma is None:
            self.luma = LumaClip(self.seed, self.width, self.height)
        return self.luma.frames(lo, hi), self.pts[lo:hi]


CLIP_REFS = {"oracle": {"MVT_SCAN_BACKEND": "oracle"},
             "sad_oracle": {"MVT_SCAN_BACKEND": "oracle",
                            "MVT_PIPELINE": "sad"}}
CLIP_PATHS = {  # path -> (environment, the reference run it must equal)
    "bits": ({}, "oracle"),
    "words": ({"MVT_SCAN_INPUT": "words"}, "oracle"),
    "grids": ({"MVT_SCAN_INPUT": "grids"}, "oracle"),
    "mv_raw": ({"MVT_SCAN_INPUT": "mv_raw"}, "oracle"),
    "sad": ({"MVT_PIPELINE": "sad"}, "sad_oracle"),
}


def clip_run(clip: str, workdir: str, name: str, env: dict):
    """``python -m mvtrim_tpu_torch``'s main on the clip under ``env``;
    (motion timestamps, output duration, metrics record)."""
    from mvtrim_tpu_torch.cli import main as cli_main
    from mvtrim_tpu_torch.pipeline.pipeline import TimingCollector

    out = os.path.join(workdir, f"out_{name}.mp4")
    metrics = os.path.join(workdir, f"metrics_{name}.jsonl")
    keys = ("MVT_SCAN_BACKEND", "MVT_SCAN_INPUT", "MVT_PIPELINE",
            "MVT_METRICS_JSON")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(env, MVT_METRICS_JSON=metrics)
    try:
        TimingCollector.clear()
        t0 = time.perf_counter()
        rc = cli_main([clip, out])
        wall = time.perf_counter() - t0
        # the motion timestamps themselves: one more scan, same config
        cfg = Config.from_env()
        pipe = ProcessingPipeline(clip, out, cfg=cfg)
        with native.VideoReader(clip) as r:
            pipe.duration = r.duration
            fps, w, h = r.fps, r.width, r.height
        kind = "sad" if cfg.pipeline_mode == "sad" else "mv"
        motion_ts = sorted(pipe._parallel_scan(kind, fps, w, h).motion_ts)
        TimingCollector.clear()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError(f"{name}: cli exit {rc}")
    with native.VideoReader(out) as r:
        out_dur = r.duration
    with open(metrics) as f:
        rec = json.loads(f.readlines()[-1])
    log(f"e2e clip [{name}] rc={rc} wall {wall:.3f} s, output "
        f"{out_dur:.3f} s, saved {rec['saved_pct']:.3f}%, "
        f"{len(motion_ts)} motion frames, phases_us "
        f"{json.dumps(rec['phases_us'])}")
    return motion_ts, out_dur, rec


def clip_path(clip: str, workdir: str, name: str, refs: dict):
    env, ref_name = CLIP_PATHS[name]

    def run() -> dict:
        (motion_ts, out_dur, rec), repacks = counting_repacks(
            lambda: clip_run(clip, workdir, name, env))
        if name == "bits":
            check_no_repack(repacks)
        ref_ts, ref_dur, _ = refs[ref_name]
        if motion_ts != ref_ts or abs(out_dur - ref_dur) > 1e-3:
            raise AssertionError(f"{name}: differs from {ref_name}")
        return rec["phases_us"]

    return run


def tune_sweep(open_reader, kind: str, device_stats: bool, backend: str,
               mesh=None) -> list:
    """tools.tune's ``kind`` route over ``open_reader()``."""
    from mvtrim_tpu_torch.tools import tune

    cfg = Config(scan_backend=backend, **(
        {"chunk_duration_sec": TUNE_SAD_CHUNK_SEC} if kind == "sad" else {}))
    with open_reader() as reader:
        if kind == "sad":
            return tune.sweep_sad_reader(
                reader, TUNE_SAD_THRESHOLDS, TUNE_CLUSTERS, cfg=cfg,
                device_stats=device_stats, mesh=mesh)
        return tune.sweep_reader(
            reader, TUNE_THRESHOLDS, TUNE_VECTORS, TUNE_CLUSTERS, cfg=cfg,
            device_stats=device_stats, scan_input=kind, mesh=mesh)


def tune_refs(open_reader, kind: str) -> tuple[dict, float]:
    """The CPU build's rows of the route, with and without
    --device-stats, and the seconds they took."""
    t0 = time.perf_counter()
    refs = {ds: tune_sweep(open_reader, kind, ds, "torch")
            for ds in (False, True)}
    if not any(r["motion_frames"] for r in refs[False]):
        raise AssertionError(f"tune {kind}: no config found motion")
    return refs, time.perf_counter() - t0


def tune_path(open_reader, kind: str, label: str, refs, mesh: bool = False):
    """tools.tune's ``kind`` route over ``open_reader()`` (a decoded clip
    or a SeededReader), on the card, against the CPU build's rows
    ``refs``: equal, with and without --device-stats (saved_pct within
    0.01 there, the f32 sums' order may differ).  With ``mesh``, the route
    runs as ``tune --mesh 1`` (a one-card mesh), and the same call on the
    CPU build, a one-shard CPU mesh, must give the reference rows too."""
    from mvtrim_tpu_torch.parallel.mesh import build_mesh

    refs, ref_s = refs
    name = f"tune {kind}{' --mesh 1' if mesh else ''}"
    if mesh:
        t0 = time.perf_counter()
        rows = tune_sweep(open_reader, kind, False, "torch",
                          build_mesh(1, device="cpu"))
        if rows != refs[False]:
            raise AssertionError(f"{name}: the CPU build's mesh rows differ")
        ref_s = time.perf_counter() - t0

    def run() -> dict:
        t0 = time.perf_counter()
        for ds, ref in refs.items():
            rows = tune_sweep(open_reader, kind, ds, "auto",
                              build_mesh(1) if mesh else None)
            if len(rows) != len(ref):
                raise AssertionError(f"{name}: {len(rows)} rows")
            for got, want in zip(rows, ref):
                if ({k: v for k, v in got.items() if k != "saved_pct"}
                        != {k: v for k, v in want.items()
                            if k != "saved_pct"}
                        or abs(got["saved_pct"] - want["saved_pct"])
                        > (0.01 if ds else 0.0)):
                    raise AssertionError(f"{name}: {got} != {want}")
        tune_s = time.perf_counter() - t0
        log(f"e2e {label} {name}: {len(refs[False])} configs, rows on the "
            f"card == the CPU build's, with and without --device-stats; "
            f"both sweeps {tune_s * 1e3:.3f} ms on the card, "
            f"{ref_s * 1e3:.3f} ms on the CPU build")
        return {"tune_ms": tune_s * 1e3}

    return run


def mv_raw_overflow_path(seed: int):
    """The pipeline's mv_raw workers and feeder
    (``ProcessingPipeline._parallel_scan``) over the seeded MV fields at
    an MV capacity below the fullest frame's count, in 10 s chunks: each
    chunk holding such a frame is re-decoded at the next power of two and
    decided on the card at that capacity; the decisions are the oracle
    backend's."""
    from mvtrim_tpu_torch.utils.timing import TimingCollector

    mvs, counts, pts = mv_data(seed)
    capacity = 1 << (int(counts.max()) - 1).bit_length() - 1
    cfg = Config(scan_input="mv_raw", mv_capacity=capacity,
                 chunk_duration_sec=OVERFLOW_CHUNK_SEC)
    ref_ts = sorted(mv_oracle_ts(seed))

    def run() -> dict:
        restarts = []

        class Overflowing(SeededReader):
            def scan_mvs(self, *args, **kw):
                out = super().scan_mvs(*args, **kw)
                if (out[1] < 0).any():
                    restarts.append(int(-out[1].min()))
                return out

        pipe = ProcessingPipeline("seeded-mv_raw", "", cfg=cfg)
        pipe.open_reader = lambda mode: Overflowing(seed, CLIP_SEC)
        pipe.duration = CLIP_SEC
        t0 = time.perf_counter()
        result = pipe._parallel_scan("mv", FPS, 1920, 1080)
        scan_s = time.perf_counter() - t0
        TimingCollector.clear()
        same = (sorted(result.motion_ts) == ref_ts
                and result.frames_scanned == len(pts))
        log(f"e2e mv_raw overflow 1080p {len(pts)} frames at MVT_MV_CAPACITY="
            f"{capacity} (fullest frame {int(counts.max())} MVs): "
            f"{len(restarts)} chunk scans overflowed and were re-decoded at "
            f"a larger capacity; {len(result.motion_ts)} motion frames, "
            f"identical to the oracle backend: {same}; scan "
            f"{scan_s * 1e3:.3f} ms")
        if not restarts:
            raise AssertionError("mv_raw overflow: no chunk overflowed")
        if not same:
            raise AssertionError("mv_raw overflow: differs from the oracle")
        return {"scan_ms": scan_s * 1e3}

    return run


def block_sad_numpy(seq: np.ndarray, block: int, geom: GridGeometry):
    """NumPy block SAD: uint8 [1 + n, H, W] -> int64 [n, gh, gw], frame
    i + 1 against frame i, pixels past the frame counting zero."""
    d = np.abs(seq[1:].astype(np.int16) - seq[:-1].astype(np.int16))
    n, h, w = d.shape
    full = np.zeros((n, geom.gh * block, geom.gw * block), np.int16)
    full[:, :h, :w] = d
    # a block's columns first, then its rows
    cols = full.reshape(n, geom.gh * block, geom.gw, block).sum(
        axis=3, dtype=np.int64)
    return cols.reshape(n, geom.gh, block, geom.gw).sum(axis=2)


@functools.lru_cache(maxsize=4)
def archive_truth(seed: int, payload: str, seconds: float,
                  chunk_sec: float = 0.0) -> dict:
    """The NumPy oracle's decisions over the seeded data an archive scan
    of ``seconds`` reads: the cluster rule on the masks (bits), or the
    SAD contract chunk by chunk in chunks of ``chunk_sec``, a chunk's
    first frame never motion (sad) -> {"segments", "motion_frames"}."""
    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    n = int(seconds * FPS)
    pts = np.arange(n) / FPS
    if payload == "bits":
        active, _ = synthetic_masks(seed, geom)
        motion = oracle_counts(active[:n].astype(np.uint8), geom) >= need
    else:
        clip = LumaClip(seed, 1920, 1080)
        bound = sad_ops.sad_threshold_sum(cfg.sad_threshold, cfg.block_size)
        motion = np.zeros(n, bool)
        chunk = int(chunk_sec * FPS)
        for c0 in range(0, n, chunk):
            prev = None
            for lo in range(c0, min(c0 + chunk, n), 32):
                frames = clip.frames(lo, min(lo + 32, c0 + chunk, n))
                seq = frames if prev is None else np.concatenate(
                    [prev[None], frames])
                counts = oracle.count_clusters_batch(
                    (block_sad_numpy(seq, cfg.block_size, geom) >= bound)
                    .astype(np.uint8), vectors_needed=1, y_min=geom.y_min,
                    y_max=geom.y_max)
                first = lo + (1 if prev is None else 0)
                motion[first:lo + len(frames)] = counts >= need
                prev = frames[-1]
    ts = oracle.merge_timestamps(pts[motion].tolist())
    segments = oracle.segments_from_timestamps(
        ts, max_gap_sec=cfg.max_gap_sec, padding_sec=cfg.padding_sec,
        duration=seconds)
    return {"segments": _segments_text(segments),
            "motion_frames": int(ts.size)}


ARCHIVE_SECONDS = {"bits": ARCHIVE_BITS_SEC, "sad": ARCHIVE_SAD_SEC}


def interleaving_opener(seed: int, seconds: float):
    """open_reader() for a SAD archive scan with two decode workers: each
    worker's SeededReader holds its first continuation scan until the
    other worker's reader reaches its own.  Both workers' first parts are
    then fed before either second part, so at least one second part comes
    after another chunk's rows, and its carry goes in as a placeholder
    row."""
    barrier = threading.Barrier(ARCHIVE_SAD_WORKERS)

    class Interleaving(SeededReader):
        waited = False

        def scan_luma(self, start, end, *, resume=False, **kw):
            if resume and not self.waited:
                self.waited = True
                barrier.wait(timeout=RANK_TIMEOUT)
            return super().scan_luma(start, end, resume=resume, **kw)

    return functools.partial(Interleaving, seed, seconds)


def counting_rows(run):
    """run() with the rows that the archive's SAD steps decide counted:
    (its result, the rows)."""
    from mvtrim_tpu_torch.parallel import archive

    rows = []
    real = archive.sharded_sad_scan_step

    def counting(*args, **kwargs):
        step = real(*args, **kwargs)

        def counted_step(luma, valid):
            rows.append(len(valid))
            return step(luma, valid)

        return counted_step

    archive.sharded_sad_scan_step = counting
    try:
        return run(), sum(rows)
    finally:
        archive.sharded_sad_scan_step = real


def archive_path(seed: int, payload: str):
    """The archive scan (``scan_archive_reader``) over the seeded data on
    the ``payload``, its mesh the card (``build_mesh()``), against the
    same call with the CPU build and a one-shard CPU mesh, and the NumPy
    oracle: segments and stats equal.  The SAD scan's decode workers
    interleave their chunks' parts, and both runs must feed placeholder
    rows (rows decided past the frames scanned)."""
    from mvtrim_tpu_torch.parallel.archive import scan_archive_reader
    from mvtrim_tpu_torch.parallel.mesh import build_mesh

    seconds = ARCHIVE_SECONDS[payload]
    sad = payload == "sad"
    cfg = Config(**({"chunk_duration_sec": ARCHIVE_SAD_CHUNK_SEC} if sad
                    else {}))

    def scan(backend, mesh=None):
        opener = (interleaving_opener(seed, seconds) if sad else
                  functools.partial(SeededReader, seed, seconds))
        (segments, duration, stats), rows = counting_rows(
            lambda: scan_archive_reader(
                opener, dataclasses.replace(cfg, scan_backend=backend),
                name=f"seeded-{payload}", frames_per_device=ARCHIVE_FPD,
                payload=payload, mesh=mesh,
                decode_workers=ARCHIVE_SAD_WORKERS if sad else 0))
        placeholders = rows - stats["frames_scanned"] if sad else 0
        if sad and placeholders < 1:
            raise AssertionError(f"archive sad ({backend}): no placeholder "
                                 f"row was fed ({rows} rows)")
        return segments, duration, stats, placeholders

    t0 = time.perf_counter()
    truth = archive_truth(seed, payload, seconds, cfg.chunk_duration_sec)
    truth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = scan("torch", build_mesh(1, device="cpu"))
    ref_s = time.perf_counter() - t0
    if (_segments_text(ref[0]) != truth["segments"]
            or ref[2]["motion_frames"] != truth["motion_frames"]
            or not truth["segments"]):
        raise AssertionError(f"archive {payload}: the CPU build {ref[0]} "
                             f"!= the oracle {truth}")

    def run() -> dict:
        t0 = time.perf_counter()
        segments, duration, stats, placeholders = scan("auto")
        wall = time.perf_counter() - t0
        keys = ("frames_scanned", "frames_with_mvs", "motion_frames",
                "dispatches", "global_batch", "payload")
        same = (_segments_text(segments) == truth["segments"]
                and duration == ref[1]
                and all(stats[k] == ref[2][k] for k in keys))
        parts = (f" in {cfg.chunk_duration_sec:g} s chunks over "
                 f"{ARCHIVE_SAD_WORKERS} decode workers, {placeholders} "
                 f"placeholder rows fed (CPU build: {ref[3]})" if sad else "")
        log(f"e2e archive {payload} seeded 1080p {seconds:g} s{parts}: "
            f"{stats['frames_scanned']} frames in {stats['dispatches']} "
            f"dispatches of up to {stats['global_batch']} frames over mesh "
            f"{stats['mesh']}, {stats['motion_frames']} motion frames, "
            f"segments {truth['segments']}; identical to the CPU build and "
            f"the oracle: {same}; wall {wall * 1e3:.3f} ms on the card "
            f"({wall / (seconds / 60) * 1e3:.3f} ms a seeded minute, the "
            f"stand-in reader's frame making included), "
            f"{ref_s * 1e3:.3f} ms on the CPU build, oracle "
            f"{truth_s * 1e3:.3f} ms")
        if not same:
            raise AssertionError(f"archive {payload}: {stats} differs from "
                                 f"{ref[2]}")
        return {"wall_ms": wall * 1e3, "dispatches": stats["dispatches"]}

    return run


RANK_SCRIPT = """
import functools, json, sys
import chip_smoke as S
from mvtrim_tpu_torch import Config
from mvtrim_tpu_torch.parallel import distributed
from mvtrim_tpu_torch.parallel.archive import scan_archive_multiprocess_reader
from mvtrim_tpu_torch.parallel.mesh import build_process_mesh

assert distributed.initialize(), "the process group did not form"
for wrapper, _, _ in S.KERNELS.values():
    wrapper.launches = 0
mesh = build_process_mesh()
segments, _, stats = scan_archive_multiprocess_reader(
    functools.partial(S.SeededReader, int(sys.argv[1]), S.ARCHIVE_BITS_SEC),
    Config(chunk_duration_sec=S.ARCHIVE_2RANK_CHUNK_SEC), name="seeded-bits",
    mesh=mesh,
    frames_per_device=S.ARCHIVE_FPD)
print(json.dumps({
    "rank": distributed.world()[1], "device": str(mesh.devices[0, 0]),
    "segments": [[s.start, s.end] for s in segments], "stats": stats,
    "launches": {n: spec[0].launches for n, spec in S.KERNELS.items()}}))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def archive_2rank_path(seed: int):
    """``scan_archive_multiprocess_reader`` in two ranks (subprocesses
    joined by gloo on this host), both deciding on this card: every
    rank's segments and counts equal the NumPy oracle's over the whole
    seeded stream.  Rank 1 has fewer chunks than rank 0, so it must join
    dispatches with no frames of its own (fewer launches than
    dispatches).  The ranks' launch counts come back with their
    results."""
    truth = archive_truth(seed, "bits", ARCHIVE_BITS_SEC)
    here = os.path.dirname(os.path.abspath(__file__))

    def run() -> dict:
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(seed)], cwd=here,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for p, (_, err) in zip(procs, outs):
            if p.returncode:
                raise AssertionError(f"archive rank exited {p.returncode}: "
                                     f"{err[-2000:]}")
        results = [json.loads(out.strip().splitlines()[-1])
                   for out, _ in outs]
        launches = {name: sum(r["launches"][name] for r in results)
                    for name in KERNELS}
        n = int(ARCHIVE_BITS_SEC * FPS)
        same = all(
            [tuple(x) for x in r["segments"]] == truth["segments"]
            and r["stats"]["motion_frames"] == truth["motion_frames"]
            and r["stats"]["frames_scanned"] == n
            for r in results)
        dispatches = results[0]["stats"]["dispatches"]
        per_rank = [r["launches"]["word_cluster_counts"] for r in results]
        log(f"e2e archive bits, 2 ranks (gloo) on "
            f"{[r['device'] for r in results]}, "
            f"{ARCHIVE_2RANK_CHUNK_SEC:g} s chunks: "
            f"{[r['stats']['frames_scanned'] for r in results]} frames, "
            f"{dispatches} dispatches a rank, word_cluster launches a rank "
            f"{per_rank}; segments identical to the oracle on every rank: "
            f"{same}; wall {wall * 1e3:.3f} ms (both processes' start "
            f"included)")
        if not same:
            raise AssertionError(f"archive 2 ranks: {results} != {truth}")
        if min(per_rank) >= dispatches:
            raise AssertionError(f"archive 2 ranks: no rank joined a "
                                 f"dispatch without frames ({per_rank} "
                                 f"launches, {dispatches} dispatches)")
        return {"wall_ms": wall * 1e3, "child_launches": launches}

    return run


def archive_dispatch_times(seed: int, card: str) -> dict:
    """One archive dispatch's parts on the card at the archive paths'
    shapes (after the counted runs, so not counted): the H2D copy of its
    batch from pinned memory and its kernels (CUDA events, the mean over
    repeated calls on one device-resident batch), and the whole sharded
    step call (host clock, to the decisions back on the host)."""
    from mvtrim_tpu_torch.parallel import mesh as mesh_ops

    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    mesh = mesh_ops.build_mesh()
    rows = min(ARCHIVE_FPD, (256 << 20) // (1920 * 1080))
    cases = {
        "bits": (bits_data(seed)[:ARCHIVE_FPD],
                 lambda t: cluster_ops.cluster_bits_op(
                     t, geom, cfg.clusters_needed)[0],
                 mesh_ops.sharded_bits_scan_step(geom, cfg, mesh),
                 lambda x: (x,)),
        "sad": (LumaClip(seed, 1920, 1080).frames(0, rows + 1),
                lambda t: sad_ops.sad_op(
                    t, geom, sad_threshold=cfg.sad_threshold,
                    block_size=cfg.block_size,
                    clusters_needed=cfg.clusters_needed)[0],
                mesh_ops.sharded_sad_scan_step(geom, cfg, mesh),
                lambda x: (x, np.ones(len(x) - 1, bool)))}
    out = {}
    for payload, (batch, kernels, step, args) in cases.items():
        pinned = torch.from_numpy(batch).pin_memory()
        dst = torch.empty(pinned.shape, dtype=pinned.dtype, device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        dst.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(8):
            dst.copy_(pinned, non_blocking=True)
        stop.record()
        torch.cuda.synchronize()
        h2d_ms = start.elapsed_time(stop) / 8
        kernel_ms, _ = _time(kernels, [dst], 32)
        for _ in range(2):
            step(*args(batch))
        t0 = time.perf_counter()
        for _ in range(8):
            step(*args(batch))
        step_ms = (time.perf_counter() - t0) / 8 * 1e3
        out[payload] = {"h2d_ms": h2d_ms, "kernel_ms": kernel_ms,
                        "step_ms": step_ms}
        log(f"archive {payload} dispatch of {len(batch)} rows "
            f"({batch.nbytes / 1e6:.3f} MB) on {card}: H2D from pinned "
            f"memory {h2d_ms * 1e3:.3f} us, kernels (event) "
            f"{kernel_ms * 1e3:.3f} us, the whole sharded step call "
            f"{step_ms * 1e3:.3f} us (host clock)")
        del pinned, dst
    torch.cuda.empty_cache()
    return out


def phase_doctor(have_native: bool) -> None:
    """tools.doctor's checks: its report on lines of their own; every CUDA
    check must pass, and without the native library libav must be a failed
    check (not a crash)."""
    from mvtrim_tpu_torch.tools import doctor

    t0 = time.perf_counter()
    results = doctor.run_checks()
    for line in doctor.report(results).splitlines():
        if line:
            log(f"doctor: {line}")
    log(f"doctor: {time.perf_counter() - t0:.3f} s")
    status = {r["name"]: r["status"] for r in results}
    if "end-to-end (auto)" not in status:
        raise AssertionError(f"doctor: no end-to-end check on the card: "
                             f"{sorted(status)}")
    for name in ("cuda-devices", "nvcc", "kernel-library", "device-mesh"):
        if status[name] != "ok":
            raise AssertionError(f"doctor: {name} is {status[name]}")
    if not have_native and status["libav"] != "fail":
        raise AssertionError("doctor: libav did not fail without it")


def counted(run) -> dict:
    """Run one path with every launch count set to 0 just before it;
    the counts just after, with those of the processes it started."""
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    out = run() or {}
    counts = {name: spec[0].launches for name, spec in KERNELS.items()}
    for name, n in out.get("child_launches", {}).items():
        counts[name] += n
    return counts


def phase_main_paths(seed: int, have_native: bool) -> dict:
    """Every ported path, each counted on its own: path -> launches."""
    launches = {}
    with tempfile.TemporaryDirectory() as workdir:
        if have_native:
            clip = os.path.join(workdir, "cam1080.mp4")
            t0 = time.perf_counter()
            native.synthesize(clip, width=1920, height=1080, fps=FPS,
                              duration=CLIP_SEC, codec="libx264", noise=2,
                              motion_windows=MOTION_WINDOWS)
            log(f"synthesized {clip} in {time.perf_counter() - t0:.3f} s")
            refs = {name: clip_run(clip, workdir, name, env)
                    for name, env in CLIP_REFS.items()}
            runs = {name: clip_path(clip, workdir, name, refs)
                    for name in CLIP_PATHS}
            readers = {kind: (functools.partial(native.VideoReader, clip),
                              "clip") for kind in ("grids", "mv_raw", "sad")}
        else:
            runs = {p: mv_path(seed, p) for p in ("bits", "words", "grids")}
            runs["mv_raw"] = mv_raw_path(seed)
            runs["sad"] = sad_path(seed)
            readers = {}
            for kind in ("grids", "mv_raw", "sad"):
                seconds = TUNE_SAD_SEC if kind == "sad" else TUNE_MV_SEC
                readers[kind] = (functools.partial(SeededReader, seed,
                                                   seconds),
                                 f"seeded 1080p {seconds:g} s")
        for kind, (opener, label) in readers.items():
            refs = tune_refs(opener, kind)
            runs[f"tune_{kind}"] = tune_path(opener, kind, label, refs)
            if kind != "mv_raw":
                runs[f"tune_{kind}_mesh"] = tune_path(opener, kind, label,
                                                      refs, mesh=True)
        # over the stand-in reader whether or not libav loads
        runs["mv_raw_overflow"] = mv_raw_overflow_path(seed)
        runs["archive_bits"] = archive_path(seed, "bits")
        runs["archive_sad"] = archive_path(seed, "sad")
        runs["archive_bits_2rank"] = archive_2rank_path(seed)
        for name, run in runs.items():
            launches[name] = counted(run)
    for path, names in PATH_KERNELS.items():
        if path == "watch" or path.startswith("replay_"):
            continue        # phases 7 and 8's
        log(f"kernel launches in the {path} path: {launches[path]}")
        for name in names:
            if launches[path][name] == 0:
                raise AssertionError(
                    f"the {path} path never launched {name}")
    return launches


# --- phase 5 ---

def _time(fn, batches, iters: int) -> tuple[float, torch.Tensor]:
    """ms per call over `iters` calls rotating through `batches`; the
    outputs of every call are kept and summed after the clock stops."""
    outs = []
    for i in range(3):
        fn(batches[i % len(batches)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        outs.append(fn(batches[i % len(batches)]))
    stop.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(stop) / iters,
            torch.stack(outs).sum(dtype=torch.int64))


def _turns(fns: dict, batches, refs, iters: dict) -> dict:
    """Time each function in turns (a, b, b, a, ...): mean ms per call
    and the runs; every checksum must equal the plain version's."""
    names = list(fns)
    runs: dict[str, list[float]] = {}
    for name in names + names[::-1]:
        ms, checksum = _time(fns[name], batches, iters[name])
        expect = sum(refs[i % len(batches)] for i in range(iters[name]))
        if int(checksum) != expect:
            raise AssertionError(f"{name}: checksum {int(checksum)} != "
                                 f"{expect}")
        runs.setdefault(name, []).append(ms)
    return {name: (sum(r) / len(r), r) for name, r in runs.items()}


def offset_copy(t: torch.Tensor, offset: int) -> torch.Tensor:
    """t's values in a tensor whose base lies offset bytes past an
    aligned address."""
    buf = torch.empty(t.numel() * t.element_size() + offset,
                      dtype=torch.uint8, device=t.device)
    return buf[offset:].view(t.dtype).view(t.shape).copy_(t)


def phase_timing_words(rng, seed: int, card: str) -> dict:
    """K1 at each K1_TIMING cell and payload (the bits at their own pitch,
    the words payload at 4 * gww), on device-resident batches of random
    bytes rotated past the L2: event time in turns with the plain version,
    device time (torch.profiler), host enqueue a call; where a call's host
    time goes; the feeder's dispatch of a chunk.  Returns the kernels
    line's entry, 1080p B = 2048 bits, and the cells' numbers."""
    cfg = Config()
    need = cfg.clusters_needed
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    cells = {}
    for label, (width, height), b in K1_TIMING:
        geom = GridGeometry.build(width, height, cfg)
        gwb = (geom.gw + 7) // 8
        n = max(2, min(128, math.ceil(K1_ROTATED_BYTES
                                      / (b * geom.gh * gwb))))
        sets = [word_payloads(torch.randint(
            0, 256, (b, geom.gh, gwb), dtype=torch.uint8, device="cuda",
            generator=gen), geom) for _ in range(n)]
        ref = [int(cluster_ops.word_cluster_counts_plain(
            p["words"][1], geom).sum()) for p in sets]
        for name, (op, _) in sets[0].items():
            batches = [p[name][1] for p in sets]
            pitch = gwb if name == "bits" else 4 * ((geom.gw + 31) // 32)

            def kernel(t, op=op, geom=geom):
                return op(t, geom, need)[0]

            def plain(t, name=name, geom=geom):
                if name == "bits":
                    return cluster_ops.bits_cluster_counts_plain(t, geom)
                return cluster_ops.word_cluster_counts_plain(t, geom)

            t = _turns({"plain": plain, "kernel": kernel}, batches, ref,
                       {"plain": 16, "kernel": 256})
            (k_ms, k_runs), (p_ms, p_runs) = t["kernel"], t["plain"]
            dev_us, dev_text = audit.profiler_time(kernel, batches,
                                                   "word_cluster_kernel")
            # one batch over and over, as the pipeline's kernel finds its
            # batch in the L2 right after the H2D copy; and C1, the same
            # rows streamed on a launch of its own, over the same batches
            warm_us, warm_text = audit.profiler_time(kernel, batches[:1],
                                                     "word_cluster_kernel")
            ctrl_us, ctrl_text = audit.profiler_time(
                lambda t, geom=geom: controls.word_stream_control(t, geom),
                batches, "word_bit0_control_kernel")
            host_us = audit.host_time(kernel, batches)
            bound = word_bound(geom, b, pitch)
            key = f"{label} B={b} {name}"
            cells[key] = {"ms": k_ms, "plain_ms": p_ms, "device_us": dev_us,
                          "warm_us": warm_us, "control_us": ctrl_us,
                          "host_us": host_us, **bound}
            log(f"word_cluster {key} (pitch {pitch} B, {n} batches "
                f"rotated, {bound['nbytes'] / 1e6:.3f} MB the function "
                f"moves) on {card}: device time {dev_text}; one batch "
                f"(L2-warm): {warm_text}; C1, the stream of the same rows, "
                f"on the same batches: {ctrl_text}; event "
                f"{k_ms * 1e3:.3f} us/launch (runs {k_runs} ms); host "
                f"enqueue {host_us:.3f} us a call; plain "
                f"{p_ms * 1e3:.3f} us (runs {p_runs} ms); bound "
                f"{bound['bound_ms'] * 1e3:.3f} us by {bound['bound_by']}")
        del sets
        torch.cuda.empty_cache()
    launch_steps(seed, card)
    cells["feeder"] = feeder_dispatch(rng, card)
    return {**cells["1080p B=2048 bits"], "cells": cells}


def launch_steps(seed: int, card: str) -> None:
    """Where a K1 call's host time goes at the main path's dispatch (1080p,
    B = 750 bits): host-clock us a call over 256 calls of each step on its
    own, twice in turns.  The steps of a call before this design (the
    library's lock, the device context, two output allocations, the
    stream object), this design's (one allocation and its views, the raw
    stream, the C entry point through ctypes), and the whole op call."""
    geom = GridGeometry.build(1920, 1080, Config())
    b = 750
    gwb = (geom.gw + 7) // 8
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    bits = torch.randint(0, 256, (b, geom.gh, gwb), dtype=torch.uint8,
                         device="cuda", generator=gen)
    payloads = word_payloads(bits, geom)
    dev = bits.device
    index = dev.index

    def device_context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "load_library() and its lock": _build.load_library,
        "torch.cuda.device context": device_context,
        "two torch.empty (counts, motion)": lambda: (
            torch.empty((b,), dtype=torch.int32, device=dev),
            torch.empty((b,), dtype=torch.bool, device=dev)),
        "two new_empty (counts, motion; outputs)": lambda: (
            bits.new_empty((b,), dtype=torch.int32),
            bits.new_empty((b,), dtype=torch.bool)),
        "current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "word_geometry(geom)": lambda: cluster_ops.word_geometry(geom),
        "raw current stream":
            lambda: torch._C._cuda_getCurrentRawStream(index),
    }
    def one_buffer():
        out = torch.empty((5 * b,), dtype=torch.uint8, device=dev)
        counts, motion = out.split((4 * b, b))
        return counts.view(torch.int32), motion.view(torch.bool)

    steps["one allocation, counts and motion views of it"] = one_buffer
    counts, motion = cluster_ops.outputs(bits, b)
    entry = _build.load_library().mvt_word_cluster_counts
    stream = torch._C._cuda_getCurrentRawStream(index)
    steps["the C entry point through ctypes (launches)"] = \
        lambda: entry(bits.data_ptr(), b, geom.gh, gwb, geom.gw, geom.y_min,
                      geom.y_max, 2, counts.data_ptr(), motion.data_ptr(),
                      index, stream)
    for name, (op, t) in payloads.items():
        steps[f"the whole {op.__name__} call ({name})"] = \
            lambda op=op, t=t: op(t, geom, 2)
    runs: dict[str, list[float]] = {}
    for name in list(steps) + list(steps)[::-1]:
        runs.setdefault(name, []).append(
            audit.host_time(lambda _, f=steps[name]: f(), [None]))
    for name, us in runs.items():
        log(f"K1 call step, 1080p B={b}, on {card}: {name}: "
            f"{[round(u, 3) for u in us]} us a call")


def feeder_dispatch(rng, card: str) -> dict:
    """The feeder's dispatch of one 30 s, 750-frame 1080p chunk: host-clock
    us from the call of scan_bits_async (scan_words_async) to its return
    (pinned staging, the H2D copy and the launch enqueued), 16 chunks a
    turn in the turns
    bits, words, words, bits after three, each resolved after its clock
    stops; and the repack alone on this host."""
    cfg = Config()
    det = MVClusterDetector(1920, 1080, cfg)
    chunk = int(cfg.chunk_duration_sec * FPS)
    _, bits = random_masks(rng, chunk, det.geom)
    words = cluster_ops.repack_bits_words(bits, det.geom)
    scans = {"bits": (det.scan_bits_async, bits),
             "words": (det.scan_words_async, words)}
    for scan, data in scans.values():
        for _ in range(3):
            scan(data)()
    runs: dict[str, list[float]] = {}
    for name in ("bits", "words", "words", "bits"):
        scan, data = scans[name]
        for _ in range(16):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resolve = scan(data)
            runs.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e6)
            resolve()
    t0 = time.perf_counter()
    for _ in range(32):
        cluster_ops.repack_bits_words(bits, det.geom)
    repack_us = (time.perf_counter() - t0) / 32 * 1e6
    out = {}
    for name, us in runs.items():
        out[name] = sum(us) / len(us)
        log(f"feeder dispatch of one {chunk}-frame 1080p {name} chunk on "
            f"{card} (host clock, to the return of scan_{name}_async): mean "
            f"{out[name]:.3f} us, min {min(us):.3f}, max {max(us):.3f} over "
            f"{len(us)}")
    log(f"repack_bits_words of that chunk alone on this host: "
        f"{repack_us:.3f} us")
    out["repack_us"] = repack_us
    return out


def phase_timing_map(seed: int, card: str) -> dict:
    """K3 at 1080p, B = 2048 uint8 vote grids a launch (16.7 MB), 32
    device-resident batches (534 MB, past the L2)."""
    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    b, n_batches = TIMING_BATCH
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [torch.randint(0, 4, (b, geom.gh, geom.gw), dtype=torch.uint8,
                             device="cuda", generator=gen)
               for _ in range(n_batches)]
    thr = cfg.vectors_needed
    ref = [int(cluster_ops.cluster_map_counts_plain(v, geom, thr).sum())
           for v in batches]

    def kernel(v):
        return cluster_ops.cluster_map_op(v, geom, thr,
                                          cfg.clusters_needed)[0]

    def plain(v):
        return cluster_ops.cluster_map_counts_plain(v, geom, thr)

    t = _turns({"plain": plain, "kernel": kernel}, batches, ref,
               {"plain": 64, "kernel": 256})
    (k_ms, k_runs), (p_ms, p_runs) = t["kernel"], t["plain"]
    mb = b * geom.gh * geom.gw / 1e6
    log(f"cluster_map timing 1080p B={b} uint8 ({mb:.1f} MB/launch) on "
        f"{card}: kernel {k_ms * 1e3:.3f} us/launch ({mb / k_ms:.3f} GB/s, "
        f"{b / k_ms * 1e3:.0f} frames/s; runs {k_runs} ms), plain "
        f"{p_ms * 1e3:.3f} us/launch (runs {p_runs} ms)")
    log(f"cluster_map kernel device time per launch (torch.profiler): "
        f"{audit.profiler_time(kernel, batches, 'cluster_map_kernel')[1]}; "
        f"host enqueue per call {audit.host_time(kernel, batches):.3f} us")
    _time_map_offset(kernel, batches, 1, f"1080p B={b} uint8", card)
    # the uint8 rows the counts depend on read once, counts and motion
    # written; about 7 integer operations a centre cell (four maxima, a
    # minimum, a compare, a sum)
    out = {"ms": k_ms, "plain_ms": p_ms,
           **least_time(map_bytes(geom, b, 1), b * centre_cells(geom) * 7)}
    del batches
    for label, (width, height), n_batches in MAP_WINDOW_TIMING:
        _time_map_window(seed, card, label, width, height, n_batches)
    return out


def _time_map_window(seed: int, card: str, label: str, width: int,
                     height: int, n_batches: int) -> None:
    """K3 on its own at the SAD window: B = 64 int32 block-sum grids a
    launch at the SAD bound, n_batches device-resident batches rotated;
    event-timed in turns with the plain version, and the profiler's
    device time, beside the bound."""
    cfg = Config()
    geom = GridGeometry.build(width, height, cfg)
    bound = sad_ops.sad_threshold_sum(cfg.sad_threshold, cfg.block_size)
    b = SAD_WINDOW
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    batches = [torch.randint(0, 2 * bound, (b, geom.gh, geom.gw),
                             dtype=torch.int32, device="cuda", generator=gen)
               for _ in range(n_batches)]
    ref = [int(cluster_ops.cluster_map_counts_plain(v, geom, bound).sum())
           for v in batches]

    def kernel(v):
        return cluster_ops.cluster_map_op(v, geom, bound,
                                          cfg.clusters_needed)[0]

    def plain(v):
        return cluster_ops.cluster_map_counts_plain(v, geom, bound)

    t = _turns({"plain": plain, "kernel": kernel}, batches, ref,
               {"plain": 32, "kernel": 256})
    (k_ms, k_runs), (p_ms, p_runs) = t["kernel"], t["plain"]
    nbytes = map_bytes(geom, b, 4)
    bnd = least_time(nbytes, b * centre_cells(geom) * 7)
    log(f"cluster_map timing {label} B={b} int32 at the SAD bound "
        f"({nbytes / 1e6:.2f} MB/launch, {n_batches} batches rotated) on "
        f"{card}: kernel {k_ms * 1e3:.3f} us/launch (runs {k_runs} ms), "
        f"plain {p_ms * 1e3:.3f} us/launch (runs {p_runs} ms), bound "
        f"{bnd['bound_ms'] * 1e3:.3f} us by {bnd['bound_by']}")
    log(f"cluster_map kernel device time per launch, {label} B={b} int32 "
        f"(torch.profiler): "
        f"{audit.profiler_time(kernel, batches, 'cluster_map_kernel')[1]}; "
        f"host enqueue per call {audit.host_time(kernel, batches):.3f} us")
    if label == "1080p":
        _time_map_offset(kernel, batches, 4, f"{label} B={b} int32", card)


def _time_map_offset(kernel, batches, offset: int, label: str,
                     card: str) -> None:
    """K3 on the same grids at an aligned base (four-cell loads where
    gw % 4 == 0) and at a base `offset` bytes past it (one-cell loads),
    in turns: event time, and the profiler's device time of each."""
    moved = [offset_copy(v, offset) for v in batches]
    ref = [int(kernel(v).sum()) for v in batches]
    idx = list(range(len(batches)))
    t = _turns({"aligned": lambda i: kernel(batches[i]),
                "offset": lambda i: kernel(moved[i])}, idx, ref,
               {"aligned": 256, "offset": 256})
    dev = {name: audit.profiler_time(fn, src, "cluster_map_kernel")[1]
           for name, fn, src in (("aligned", kernel, batches),
                                 ("offset", kernel, moved))}
    log(f"cluster_map {label} on {card}, aligned base against {offset} B "
        f"off: event {t['aligned'][0] * 1e3:.3f} against "
        f"{t['offset'][0] * 1e3:.3f} us/launch (runs {t['aligned'][1]} / "
        f"{t['offset'][1]} ms); device time (torch.profiler) "
        f"{dev['aligned']} against {dev['offset']}")
    del moved


def phase_timing_sad(seed: int, card: str) -> dict:
    """K6 on device-resident windows of 1 + 64 frames, rotated past the
    L2: the kernel alone, the plain version, the whole op (K6 + K3), and
    the H2D copy of one window from pinned memory; at 1080p and 4K."""
    cfg = Config()
    bs = cfg.block_size
    bound = sad_ops.sad_threshold_sum(cfg.sad_threshold, bs)
    b = SAD_WINDOW
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    out = {}
    for label, (width, height), n_win in SAD_TIMING:
        geom = GridGeometry.build(width, height, cfg)
        wins = [torch.randint(0, 256, (b + 1, height, width),
                              dtype=torch.uint8, device="cuda",
                              generator=gen) for _ in range(n_win)]
        plain_grids = [sad_ops.sad_block_grid_plain(w, bs) for w in wins]
        ref_grid = [int(g.sum(dtype=torch.int64)) for g in plain_grids]
        ref_counts = [int(cluster_ops.cluster_map_counts_plain(
            g, geom, bound).sum()) for g in plain_grids]
        del plain_grids

        def kernel(w, geom=geom):
            return sad_ops._launch_grid(w, geom, bs)

        def plain(w):
            return sad_ops.sad_block_grid_plain(w, bs)

        def whole(w, geom=geom):
            return sad_ops.sad_op(w, geom, sad_threshold=cfg.sad_threshold,
                                  block_size=bs,
                                  clusters_needed=cfg.clusters_needed)[0]

        t = _turns({"plain": plain, "kernel": kernel}, wins, ref_grid,
                   {"plain": 8, "kernel": 32})
        op_ms, op_runs = _turns({"op": whole}, wins, ref_counts,
                                {"op": 32})["op"]
        (k_ms, k_runs), (p_ms, p_runs) = t["kernel"], t["plain"]

        # H2D of one window from pinned memory
        pinned = torch.empty(wins[0].shape, dtype=torch.uint8,
                             pin_memory=True)
        pinned.copy_(wins[0])
        dst = torch.empty_like(wins[0])
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        dst.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(8):
            dst.copy_(pinned, non_blocking=True)
        stop.record()
        torch.cuda.synchronize()
        h2d_ms = start.elapsed_time(stop) / 8
        if not torch.equal(dst, wins[0]):
            raise AssertionError("H2D copy of a window differs")

        nbytes = (b + 1) * height * width
        log(f"sad_block timing {label} B={b} ({nbytes / 1e6:.1f} MB/window, "
            f"{n_win} windows rotated) on {card}: kernel "
            f"{k_ms * 1e3:.3f} us/window ({nbytes / k_ms / 1e9:.3f} TB/s of "
            f"3.35 TB/s peak counting each plane once, "
            f"{b / k_ms * 1e3:.0f} frames/s; runs {k_runs} ms); plain "
            f"{p_ms * 1e3:.3f} us/window (runs {p_runs} ms); op (SAD + "
            f"cluster_map) {op_ms * 1e3:.3f} us/window (runs {op_runs} ms); "
            f"H2D from pinned memory {h2d_ms * 1e3:.3f} us/window "
            f"({nbytes / h2d_ms / 1e6:.3f} GB/s)")
        host_us = audit.host_time(
            lambda w, g=geom: sad_ops.sad_grid_op(w, g, bs), wins)
        log(f"sad_block {label} host enqueue per sad_grid_op call: "
            f"{host_us:.3f} us")
        # the window read once (the carry plane too), the int32 grid
        # written; two integer operations a pixel (|difference|, sum)
        out[label] = {"ms": k_ms, "plain_ms": p_ms, "op_ms": op_ms,
                      "h2d_ms": h2d_ms,
                      **least_time(nbytes + b * geom.gh * geom.gw * 4,
                                   b * height * width * 2)}
        # K3 inside the op: the int32 rows its counts depend on read,
        # counts and motion written
        k3 = least_time(map_bytes(geom, b, 4), b * centre_cells(geom) * 7)
        log(f"sad_block bound {label} B={b}: "
            f"{out[label]['bound_ms'] * 1e3:.3f} us by "
            f"{out[label]['bound_by']}; cluster_map on its int32 grid: "
            f"{(op_ms - k_ms) * 1e3:.3f} us (op minus kernel) against a "
            f"bound of {k3['bound_ms'] * 1e3:.3f} us by {k3['bound_by']}")
        del wins, pinned, dst
        torch.cuda.empty_cache()
    return out


def phase_timing_mv(seed: int, card: str) -> dict:
    """The raw-MV kernel at the MV_TIMING cells, B = 2048 frames a launch
    (134.2 MB of int16 fields at 1080p, M = 8192; 268.4 MB at 4K, M =
    16384), three device-resident batches rotated past the L2: sparse
    counts (log-uniform in 1..M), full capacity, and at 1080p full
    capacity spread evenly over the frame, the kernel against its plain
    version in turns, with the profiler's device time; and at 1080p the
    H2D copy of one batch from pinned memory.  Keys "<label> <mode>",
    mode "sparse", "full" or "spread"."""
    cfg = Config()
    b, n_batches = MV_TIMING_BATCH
    bnd = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    out = {}
    for label, (width, height), m, counts_mode, layout in MV_TIMING:
        geom = GridGeometry.build(width, height, cfg)
        mode = "spread" if layout == "spread" else counts_mode
        key = f"{label} {mode}"
        batches = []
        for _ in range(n_batches):
            if counts_mode == "sparse":
                u = torch.rand((b,), generator=gen, device="cuda")
                counts = torch.exp(u * math.log(m)).to(torch.int32)
            else:
                counts = torch.full((b,), m, dtype=torch.int32,
                                    device="cuda")
            batches.append((device_mvs(gen, counts, m, width, height,
                                       layout), counts))
        ref = [int(mv_ops.mv_cluster_counts_plain(
            f, c, geom, bnd, cfg.vectors_needed, cfg.block_shift).sum())
            for f, c in batches]

        def kernel(fc):
            return mv_ops.mv_cluster_op(
                fc[0], fc[1], geom, bnd, cfg.vectors_needed,
                cfg.clusters_needed, cfg.block_shift)[0]

        def plain(fc):
            return mv_ops.mv_cluster_counts_plain(
                fc[0], fc[1], geom, bnd, cfg.vectors_needed,
                cfg.block_shift)

        t = _turns({"plain": plain, "kernel": kernel}, batches, ref,
                   {"plain": 8, "kernel": 64})
        (k_ms, k_runs), (p_ms, p_runs) = t["kernel"], t["plain"]
        # the MV rows below each count read once (8 bytes each), the
        # counts read, counts and motion written; about 12 integer
        # operations an MV (two differences, two products, a sum, the
        # bound, two shifts, four range tests) and 8 a centre cell (the
        # rule's 7 and the histogram's zeroing)
        mvs_read = sum(int(c.sum()) for _, c in batches) / n_batches
        out[key] = {"ms": k_ms, "plain_ms": p_ms, **least_time(
            mvs_read * 8 + b * 9, mvs_read * 12 + b * centre_cells(geom) * 8)}
        log(f"mv_cluster timing {label} B={b} M={m} {mode} (mean "
            f"{mvs_read / b:.1f} MVs a frame, {mvs_read * 8 / 1e6:.1f} MB "
            f"of rows below the counts of "
            f"{b * m * 8 / 1e6:.1f} MB a launch; {n_batches} batches "
            f"rotated) on {card}: kernel {k_ms * 1e3:.3f} us/launch "
            f"({b / k_ms * 1e3:.0f} frames/s; runs {k_runs} ms), plain "
            f"{p_ms * 1e3:.3f} us/launch (runs {p_runs} ms), bound "
            f"{out[key]['bound_ms'] * 1e3:.3f} us by "
            f"{out[key]['bound_by']}")
        log(f"mv_cluster kernel device time per launch (torch.profiler, "
            f"{key}): "
            f"{audit.profiler_time(kernel, batches, 'mv_cluster_kernel')[1]}; "
            f"host enqueue per call {audit.host_time(kernel, batches):.3f}"
            f" us")
        if mode == "spread":
            # the same count of MVs as "full", no cell collecting more
            # than a few: what the same-address atomics of "full" cost
            log(f"mv_cluster full capacity, boxed (a third of the MVs in "
                f"48 cells) against spread evenly: "
                f"{out[f'{label} full']['ms'] * 1e3:.3f} against "
                f"{k_ms * 1e3:.3f} us/launch")
        if mode == "spread" or label != "1080p":
            del batches
            torch.cuda.empty_cache()
            continue
        # H2D of one batch from pinned memory
        pinned = batches[0][0].cpu().pin_memory()
        dst = torch.empty_like(batches[0][0])
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        dst.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(8):
            dst.copy_(pinned, non_blocking=True)
        stop.record()
        torch.cuda.synchronize()
        h2d_ms = start.elapsed_time(stop) / 8
        if not torch.equal(dst, batches[0][0]):
            raise AssertionError("H2D copy of an MV batch differs")
        out[key]["h2d_ms"] = h2d_ms
        mb = pinned.numel() * 2 / 1e6
        log(f"H2D of one {b}-frame int16 MV batch ({mb:.1f} MB) from "
            f"pinned memory on {card}: {h2d_ms * 1e3:.3f} us "
            f"({mb / h2d_ms:.3f} GB/s)")
        del batches, pinned, dst
        torch.cuda.empty_cache()
    return out


def phase_timing(rng, seed: int, card: str) -> dict:
    """Phase 5: each kernel at its timed shape; name -> times and bound."""
    times = {"word_cluster_counts": phase_timing_words(rng, seed, card),
             "cluster_map_counts": phase_timing_map(seed, card),
             "sad_block_grid": phase_timing_sad(seed,
                                                card)[SAD_TIMING[0][0]],
             "mv_cluster_counts": phase_timing_mv(seed,
                                                  card)["1080p sparse"]}
    for name, t in times.items():
        log(f"{name}: {t['ms'] * 1e3:.3f} us a launch at its timed shape "
            f"against a bound of {t['bound_ms'] * 1e3:.3f} us by "
            f"{t['bound_by']} ({audit.HBM_BYTES_PER_S / 1e12} TB/s, "
            f"{audit.OPS_PER_S / 1e12:.0f} T operations/s) on {card}")
    return times


# --- phase 6 ---

def one_launch(wrapper, call):
    """call()'s result; raises unless it counted one launch on wrapper."""
    before = wrapper.launches
    out = call()
    if wrapper.launches != before + 1:
        raise AssertionError(f"{wrapper.__name__} counted "
                             f"{wrapper.launches - before} launches")
    return out


def phase_correctness_controls(seed: int) -> dict:
    """C1-C10 vs their plain versions on the card, on the same tensors,
    exact: C1 at both pitches (the bits' 15 B at 1080p), aligned and at a
    base 1 B (bits) or 4 B (words) off, at B = 1, 3, 750, 777 and 2048
    (B = 750 and 777 leave a CTA short of frames), at 4K and on 8K's
    frames past a block's shared memory, one launch a call; C2 and C4 on
    SAD windows, a base 1 B off too (one-byte loads); C3, C5 and C6-C10 at
    sparse and full counts (counts 0 and above M among them), C5 and C9
    also with the global histogram, C10 also at all-ones parity and M =
    16,384 (every cell 16,384: integer, not TF32), C3, C5 and C9 also at
    RAGGED_EDGES.  Returns name -> max |kernel - plain|."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    worst = dict.fromkeys(CONTROLS, 0)

    def check(name, got, plain, label):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max())
        worst[name] = max(worst[name], err)
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {label}: max |diff| {err}")

    width, height, vm, shift, large_b = WORD_LARGE
    for w, h, cfg, batches in (
            (1920, 1080, Config(), (1, 3, 750, 2048)),
            (3840, 2160, Config(), (777,)),
            (200, 144, Config(), (777,)),
            (width, height, Config(vertical_mask=vm, block_shift=shift,
                                   block_size=1 << shift), large_b)):
        geom = GridGeometry.build(w, h, cfg)
        gwb = (geom.gw + 7) // 8
        for b in batches:
            bits = torch.randint(0, 256, (b, geom.gh, gwb), dtype=torch.uint8,
                                 device="cuda", generator=gen)
            for name, t in (("bits", bits),
                            ("words", cluster_ops.bits_to_words(bits, geom))):
                for base, label in ((t, "aligned"),
                                    (offset_copy(t, WORD_OFFSETS[name]),
                                     "offset")):
                    plain = controls.word_stream_control_plain(
                        controls.word_rows(base, geom), geom)
                    check("word_stream_control", one_launch(
                        controls.word_stream_control,
                        lambda: controls.word_stream_control(base, geom)),
                        plain, f"{w}x{h} B={b} {name} {label}")
        log(f"word_stream_control {w}x{h} BLOCK_SHIFT={cfg.block_shift} "
            f"B={batches}: kernel == plain at pitches {gwb} B (bits) and "
            f"{4 * ((geom.gw + 31) // 32)} B (words), aligned and offset, "
            f"one launch a call")

    bs = Config().block_size
    for w, h, b in ((1920, 1080, SAD_WINDOW), (3840, 2160, SAD_WINDOW),
                    (1000, 562, 5), (320, 240, 3)):
        geom = GridGeometry.build(w, h, Config())
        luma = torch.randint(0, 256, (1 + b, h, w), dtype=torch.uint8,
                             device="cuda", generator=gen)
        for base, label in ((luma, "aligned"),
                            (offset_copy(luma, 1), "offset by 1 byte")):
            vec = sad_ops._vector_width(base, bs)
            check("sad_stream_control",
                  controls.sad_stream_control(base, geom, bs),
                  controls.sad_stream_control_plain(base, bs),
                  f"{w}x{h} B={b} {label}")
            check("sad_compute_control",
                  controls.sad_compute_control(base, geom, bs),
                  controls.sad_compute_control_plain(base, bs),
                  f"{w}x{h} B={b} {label}")
            log(f"sad_stream_control, sad_compute_control {w}x{h} B={b} "
                f"({label}, {vec}-byte loads): kernel == plain")

    cfg = Config()
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    for w, h, m, b, mode in ((1920, 1080, 8192, 2048, "sparse"),
                             (1920, 1080, 8192, 777, "full"),
                             (3840, 2160, 16384, 777, "sparse"),
                             (3840, 2160, 16384, 256, "full"),
                             (7680, 4320, 8192, 64, "sparse")):
        geom = GridGeometry.build(w, h, cfg)
        if mode == "full":
            counts = torch.full((b,), m, dtype=torch.int32, device="cuda")
        else:
            u = torch.rand((b,), generator=gen, device="cuda")
            counts = torch.exp(u * math.log(m)).to(torch.int32)
        counts[7::50] = 0
        mvs = device_mvs(gen, counts, m, w, h)
        label = f"{w}x{h} M={m} B={b} {mode}"
        check("mv_stream_control", controls.mv_stream_control(mvs, counts),
              controls.mv_stream_control_plain(mvs, counts), label)
        for c0 in (counts, torch.cat([counts[7:8], counts[1:]])):
            got, motion = controls.mv_compute_control(
                mvs, c0, geom, bound, cfg.vectors_needed, cfg.clusters_needed,
                cfg.block_shift)
            plain, _ = controls.mv_compute_control_plain(
                mvs, c0, geom, bound, cfg.vectors_needed, cfg.clusters_needed,
                cfg.block_shift)
            check("mv_compute_control", got, plain, label)
            if not torch.equal(motion, (plain >= need) & (c0[0] > 0)):
                raise AssertionError(f"mv_compute_control motion at {label}")
        counts[3::50] = m + 9
        check_new_mv_controls(check, mvs, counts, geom, label)
        glob = mv_ops.uses_global_histogram(geom, counts.device)
        log(f"mv_stream_control, mv_compute_control {label} (frame 0 with "
            f"its count and with none; "
            f"{'global' if glob else 'shared-memory'} histogram), C6-C10 "
            f"(counts above M among them): kernel == plain")
    for w, h in ((1920, 1080), (7680, 4320)):
        geom = GridGeometry.build(w, h, cfg)
        m = 16384
        ones = torch.zeros((2, m, 4), dtype=torch.int16, device="cuda")
        ones[:, :, :2] = 1
        want = controls.mv_matrix_control_plain(ones, geom)
        total = geom.padded_gh * geom.padded_gw * m
        if want.tolist() != [(total + 2 ** 31) % 2 ** 32 - 2 ** 31] * 2:
            raise AssertionError("mv_matrix_control_plain at all-ones parity")
        check("mv_matrix_control", controls.mv_matrix_control(ones, geom),
              want, f"{w}x{h} M={m} all-ones parity")
        log(f"mv_matrix_control {w}x{h} M={m} all-ones parity (every cell "
            f"{m}, the grid's sum {total}): kernel == plain")
    check_ragged_edges(check, gen)
    return worst


def check_new_mv_controls(check, mvs, counts, geom, label) -> None:
    """C6-C10 vs their plain versions on one MV batch."""
    cfg = Config()
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    sub = mvs[..., 0].contiguous()
    check("mv_capacity_control", controls.mv_capacity_control(mvs, counts),
          controls.mv_capacity_control_plain(mvs, counts), label)
    check("mv_capacity_control_sub",
          controls.mv_capacity_control_sub(mvs, counts, sub),
          controls.mv_capacity_control_sub_plain(mvs, counts, sub), label)
    check("mv_capacity_control_mm",
          controls.mv_capacity_control_mm(mvs, counts),
          controls.mv_capacity_control_mm_plain(mvs, counts), label)
    check("mv_votes_control", controls.mv_votes_control(
        mvs, counts, geom, bound, cfg.block_shift),
        controls.mv_votes_control_plain(mvs, counts, geom, bound,
                                        cfg.block_shift), label)
    check("mv_matrix_control", controls.mv_matrix_control(mvs, geom),
          controls.mv_matrix_control_plain(mvs, geom), label)


def ragged_edge_counts(gen, b: int, m: int) -> dict:
    """The counts that stress C3's and C9's launch (a frame to a CTA of a
    persistent grid), b
    frames at capacity m: label -> int32 [b] on the card."""
    def sparse():
        u = torch.rand((b,), generator=gen, device="cuda")
        return torch.exp(u * math.log(m)).to(torch.int32)

    zeros = torch.zeros((b,), dtype=torch.int32, device="cuda")
    one = zeros.clone()
    one[b // 2] = m
    negative = sparse()
    negative[::5] = -7
    negative[1::97] = -2 ** 31
    above = sparse()
    above[::3] = m + 1
    above[1::50] = 2 ** 31 - 1
    return {"all zero": zeros, "one frame at M among zeros": one,
            "negative counts": negative, "counts above M": above,
            "sparse": sparse(),
            "full": torch.full((b,), m, dtype=torch.int32, device="cuda")}


# (width, height, M, B, labels of ragged_edge_counts or None for all)
RAGGED_EDGES = (
    (1920, 1080, 8192, 2048, None),
    (3840, 2160, 16384, 512, None),
    (1920, 1080, 8192, 1, ("one frame at M among zeros", "sparse")),
    (1920, 1080, 8192, 3, ("one frame at M among zeros", "counts above M")),
    (1920, 1080, 8191, 777, ("sparse", "full", "counts above M")),  # odd M
    (1920, 1080, 512, 5000, ("sparse", "one frame at M among zeros",
                             "negative counts")),  # frames past the grid
    (7680, 4320, 8192, 64, ("one frame at M among zeros", "sparse")),
)


def held_cases(m: int, thr: int) -> tuple:
    """C5's edges on one payload: (label, frame 0's count, VECTORS_NEEDED):
    a held count of 0, 1, M, above M and negative at ``thr``, and at M with
    VECTORS_NEEDED 0 (every row's fill word all ones) and above any cell's
    votes (no bit ever set)."""
    return (("held count 0", 0, thr), ("held count 1", 1, thr),
            ("held count M", m, thr), ("held count above M", m + 1, thr),
            ("held count negative", -7, thr),
            ("held count M, VECTORS_NEEDED 0", m, 0),
            ("held count M, VECTORS_NEEDED above the votes", m, m + 1))


def check_ragged_edges(check, gen) -> None:
    """C3, C9 and C5 vs their plain versions, exact, at RAGGED_EDGES:
    all-zero counts, one frame at M among zeros (the batch's work in one
    frame), B = 1 and 3 (fewer frames than CTAs), counts above M, negative
    counts, sparse and full at 1080p and 4K, an odd M and a base 8 bytes
    off a 16-byte boundary (one MV a load), more frames than the grid's
    CTAs, and 8K, whose histogram takes C9's and C5's global scratch; C5
    at each payload's ``held_cases``, counts and motion.  Each call must
    count one launch on its wrapper."""
    cfg = Config()
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    need = oracle.effective_clusters_needed(cfg.clusters_needed)

    for w, h, m, b, labels in RAGGED_EDGES:
        geom = GridGeometry.build(w, h, cfg)
        cases = ragged_edge_counts(gen, b, m)
        mvs = device_mvs(gen, cases["full"], m, w, h)
        bases = [(mvs, "16-byte aligned")]
        if m % 2 == 0 and b <= 2048:
            bases.append((offset_copy(mvs, 8), "8 bytes off"))
        glob = controls.votes_scratch_cells(b, geom, 0) > 0
        if glob != (w == 7680) or glob != mv_ops.uses_global_histogram(
                geom, mvs.device):
            raise AssertionError(f"C9, C5 at {w}x{h}: global histogram "
                                 f"{glob}")
        for label in labels or tuple(cases):
            counts = cases[label]
            for base, where in bases:
                text = f"{w}x{h} M={m} B={b} {label}, base {where}"
                check("mv_stream_control", one_launch(
                    controls.mv_stream_control,
                    lambda: controls.mv_stream_control(base, counts)),
                    controls.mv_stream_control_plain(base, counts), text)
                check("mv_votes_control", one_launch(
                    controls.mv_votes_control,
                    lambda: controls.mv_votes_control(
                        base, counts, geom, bound, cfg.block_shift)),
                    controls.mv_votes_control_plain(
                        base, counts, geom, bound, cfg.block_shift), text)
        counts = cases["sparse"].clone()
        for label, held, vn in held_cases(m, cfg.vectors_needed):
            counts[0] = held
            args = (geom, bound, vn, cfg.clusters_needed, cfg.block_shift)
            for base, where in bases:
                text = f"{w}x{h} M={m} B={b} {label}, base {where}"
                got, motion = one_launch(
                    controls.mv_compute_control,
                    lambda: controls.mv_compute_control(base, counts, *args))
                plain, _ = controls.mv_compute_control_plain(base, counts,
                                                             *args)
                check("mv_compute_control", got, plain, text)
                if not torch.equal(motion, (plain >= need) & (held > 0)):
                    raise AssertionError(f"mv_compute_control motion at "
                                         f"{text}")
        log(f"mv_stream_control, mv_votes_control {w}x{h} M={m} B={b} "
            f"({', '.join(labels or tuple(cases))}), mv_compute_control "
            f"(held counts 0, 1, M, above M, negative; VECTORS_NEEDED "
            f"{cfg.vectors_needed}, 0 and {m + 1}); "
            f"{'global' if glob else 'shared-memory'} histogram; "
            f"{len(bases)} bases): kernel == plain, one launch a call")
        del mvs, bases
    torch.cuda.empty_cache()


def _control_time(name: str, fn, plain, inputs, per_input, nbytes: float,
                  ops: float, card: str,
                  ops_per_s: float = audit.OPS_PER_S) -> dict:
    """A control at the kernels line's shape: device time a launch by CUDA
    graph (64 launches over the rotated inputs), the plain version by
    events, and the bound (operations at ops_per_s)."""
    t = audit.graph_time(fn, inputs, max(64, len(inputs)), per_input, 3)
    if not t["checksum_ok"]:
        raise AssertionError(f"{name}: checksum of the graph's launches")
    runs = sorted(t["runs_us"])
    plain_ms, checksum = _time(plain, inputs, 4)
    if int(checksum) != audit.expected_total(per_input, len(inputs), 4):
        raise AssertionError(f"{name}: plain version's checksum")
    out = {"ms": runs[1] * 1e-3, "plain_ms": plain_ms,
           **least_time(nbytes, ops, ops_per_s)}
    log(f"{name} on {card}: {t['runs_us']} us a launch (CUDA graph); plain "
        f"{plain_ms * 1e3:.3f} us; bound {out['bound_ms'] * 1e3:.3f} us by "
        f"{out['bound_by']}")
    return out


def phase_timing_controls(seed: int, card: str) -> dict:
    """C1-C10 at the shapes of the kernels line: C1 on the bits payload at
    1080p B = 2048, C2 and C4 on a 1080p SAD window, C3, C5 and C6-C10 at
    1080p M = 8192 with sparse counts (C6-C8 and C10 read every slot
    whatever the counts), each on buffers rotated past the L2; beside C6
    the one PyTorch call over the same bytes, ``torch.sum`` of the fields
    (the count add excluded)."""
    cfg = Config()
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    out = {"word_stream_control": time_word_control(gen, card)}
    geom = GridGeometry.build(1920, 1080, cfg)
    b = 2048
    bs, h, w = cfg.block_size, 1080, 1920
    wins = [torch.randint(0, 256, (1 + SAD_WINDOW, h, w), dtype=torch.uint8,
                          device="cuda", generator=gen) for _ in range(2)]
    grid_bytes = SAD_WINDOW * geom.gh * geom.gw * 4
    for name, fn, plain, nbytes in (
            ("sad_stream_control", controls.sad_stream_control,
             controls.sad_stream_control_plain,
             (1 + SAD_WINDOW) * h * w + grid_bytes),
            ("sad_compute_control", controls.sad_compute_control,
             controls.sad_compute_control_plain, 2 * h * w + grid_bytes)):
        out[name] = _control_time(
            f"{name} 1080p B={SAD_WINDOW}",
            lambda t, fn=fn: fn(t, geom, bs),
            lambda t, plain=plain: plain(t, bs), wins,
            [int(plain(t, bs).sum(dtype=torch.int64)) for t in wins],
            nbytes, SAD_WINDOW * h * w * 2, card)
    del wins

    m = 8192
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    args = (geom, bound, cfg.vectors_needed, cfg.clusters_needed,
            cfg.block_shift)
    sets, held = [], 0
    while len(sets) < 2 or held < audit.ROTATED_BYTES:
        u = torch.rand((b,), generator=gen, device="cuda")
        counts = torch.exp(u * math.log(m)).to(torch.int32)
        sets.append((device_mvs(gen, counts, m, 1920, 1080), counts))
        held += int(counts.sum()) * 8
    rows = sum(int(c.sum()) for _, c in sets) / len(sets)
    first = sum(int(c[0]) for _, c in sets) / len(sets)
    out["mv_stream_control"] = _control_time(
        "mv_stream_control 1080p M=8192 sparse",
        lambda fc: controls.mv_stream_control(*fc),
        lambda fc: controls.mv_stream_control_plain(*fc), sets,
        [int(controls.mv_stream_control_plain(*fc).sum()) for fc in sets],
        rows * 8 + b * 8, rows * 4, card)
    out["mv_compute_control"] = _control_time(
        "mv_compute_control 1080p M=8192 sparse",
        lambda fc: controls.mv_compute_control(*fc, *args)[0],
        lambda fc: controls.mv_compute_control_plain(*fc, *args)[0], sets,
        [int(controls.mv_compute_control_plain(*fc, *args)[0].sum())
         for fc in sets],
        first * 8 + b * 9, b * (first * 12 + centre_cells(geom) * 8), card)
    out.update(time_new_mv_controls(sets, geom, rows, card))
    del sets
    torch.cuda.empty_cache()
    return out


def time_word_control(gen, card: str) -> dict:
    """C1 on the bits payload at 1080p B = 2048 over buffers rotated past
    the L2, and its library time: ``torch.sum`` of the same bytes in int32,
    by CUDA graph as C1 (the same bytes, not the function; the port never
    calls it)."""
    geom = GridGeometry.build(1920, 1080, Config())
    b, gwb = 2048, (geom.gw + 7) // 8
    k = math.ceil(audit.ROTATED_BYTES / (b * geom.gh * gwb))
    bits = [torch.randint(0, 256, (b, geom.gh, gwb), dtype=torch.uint8,
                          device="cuda", generator=gen) for _ in range(k)]

    def c1_plain(t):
        return controls.word_stream_control_plain(t, geom)

    out = _control_time(
        "word_stream_control 1080p B=2048 bits",
        lambda t: controls.word_stream_control(t, geom), c1_plain, bits,
        [int(c1_plain(t).sum()) for t in bits], b * (geom.gh * gwb + 4),
        b * geom.gh * ((geom.gw + 31) // 32) * 2, card)
    lib = audit.graph_time(
        lambda t: torch.sum(t, dim=(1, 2), dtype=torch.int32), bits,
        max(64, len(bits)), [int(t.sum(dtype=torch.int64)) for t in bits], 3)
    if not lib["checksum_ok"]:
        raise AssertionError("torch.sum of C1's bytes: checksum")
    out["library_ms"] = sorted(lib["runs_us"])[1] * 1e-3
    log(f"torch.sum(rows, dim=(1, 2), dtype=torch.int32) 1080p B={b} bits "
        f"on {card}: {lib['runs_us']} us a call (CUDA graph; C1's bytes, "
        f"not its function)")
    return out


def time_new_mv_controls(sets, geom: GridGeometry, rows: float,
                         card: str) -> dict:
    """C6-C10 over the rotated (mvs, counts) sets, C7 with a copy of each
    set's dst_x; C6's library time (``torch.sum`` of the fields in int32
    over the same bytes, which the port never calls) by events."""
    cfg = Config()
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    b, m, _ = sets[0][0].shape
    subs = [(f, c, f[..., 0].contiguous()) for f, c in sets]
    out = {}
    for name, fn, plain, inputs, nbytes, ops, rate in (
            ("mv_capacity_control", controls.mv_capacity_control,
             controls.mv_capacity_control_plain, sets, b * (m * 8 + 8), 0.0,
             audit.OPS_PER_S),
            ("mv_capacity_control_sub", controls.mv_capacity_control_sub,
             controls.mv_capacity_control_sub_plain, subs, b * (m * 10 + 8),
             0.0, audit.OPS_PER_S),
            ("mv_capacity_control_mm", controls.mv_capacity_control_mm,
             controls.mv_capacity_control_mm_plain, sets, b * (m * 8 + 8),
             0.0, audit.OPS_PER_S),
            ("mv_votes_control",
             lambda f, c: controls.mv_votes_control(f, c, geom, bound,
                                                    cfg.block_shift),
             lambda f, c: controls.mv_votes_control_plain(
                 f, c, geom, bound, cfg.block_shift), sets,
             rows * 8 + b * 8, rows * 12, audit.OPS_PER_S),
            ("mv_matrix_control",
             lambda f, c: controls.mv_matrix_control(f, geom),
             lambda f, c: controls.mv_matrix_control_plain(f, geom), sets,
             b * (m * 8 + 4), controls.matrix_ops(geom, b, m),
             audit.TENSOR_INT8_OPS_PER_S)):
        out[name] = _control_time(
            f"{name} 1080p M={m} sparse counts",
            lambda x, fn=fn: fn(*x), lambda x, plain=plain: plain(*x),
            inputs, [int(plain(*x).sum()) for x in inputs], nbytes, ops,
            card, rate)
    del subs
    # the same bytes as C6, the count add excluded
    lib_ms, total = _time(
        lambda fc: torch.sum(fc[0], dim=(1, 2), dtype=torch.int32), sets, 64)
    per_set = [int(controls.mv_capacity_control_plain(
        f, torch.zeros_like(c)).sum()) for f, c in sets]
    if int(total) != audit.expected_total(per_set, len(sets), 64):
        raise AssertionError("torch.sum of the fields differs from C6's sum")
    out["mv_capacity_control"]["library_ms"] = lib_ms
    log(f"torch.sum(mvs, dim=(1, 2), dtype=torch.int32) 1080p M={m} on "
        f"{card}: {lib_ms * 1e3:.3f} us a call (events; C6's bytes, the "
        f"count add excluded)")
    return out


# (label, (width, height), M, counts): where --times-only times C3, C5,
# C9 and K4+K5 by CUDA graph: phase 6's shape (counts log-uniform in 1..M)
# and the bench's mv cells (bench/mv.py: log-uniform in 64..2048, full)
RAGGED_TIMING = (("1080p M=8192 1..M", (1920, 1080), 8192, "1..M"),
                 ("1080p M=8192 sparse", (1920, 1080), 8192, "sparse"),
                 ("1080p M=8192 full", (1920, 1080), 8192, "full"),
                 ("4K M=16384 sparse", (3840, 2160), 16384, "sparse"),
                 ("4K M=16384 full", (3840, 2160), 16384, "full"))


def ragged_counts(gen, b: int, m: int, mode: str) -> torch.Tensor:
    if mode == "full":
        return torch.full((b,), m, dtype=torch.int32, device="cuda")
    u = torch.rand((b,), generator=gen, device="cuda", dtype=torch.float64)
    lo, hi = (1, m - 1) if mode == "1..M" else bench_mv.SPARSE
    return torch.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo))
                     ).to(torch.int32).clamp(max=m)


def time_ragged(seed: int, card: str) -> dict:
    """C3, C9, C5 and K4+K5 at RAGGED_TIMING, B = 2048, each by CUDA graph
    (64 launches over buffers rotated past the L2, three replays),
    checksummed against the plain versions: label -> name -> the replays'
    µs a launch, C3's and C9's bound and C5's."""
    cfg = Config()
    bnd = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    shift = cfg.block_shift
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    b = 2048
    out = {}
    for label, (w, h), m, mode in RAGGED_TIMING:
        geom = GridGeometry.build(w, h, cfg)
        sets, held = [], 0
        while len(sets) < 2 or held < audit.ROTATED_BYTES:
            counts = ragged_counts(gen, b, m, mode)
            sets.append((device_mvs(gen, counts, m, w, h), counts))
            held += int(counts.sum()) * 8
        rows = sum(int(c.sum()) for _, c in sets) / len(sets)
        first = sum(int(c[0]) for _, c in sets) / len(sets)
        args = (geom, bnd, cfg.vectors_needed, cfg.clusters_needed, shift)
        pairs = {
            "mv_stream_control": (
                lambda fc: controls.mv_stream_control(*fc),
                lambda fc: controls.mv_stream_control_plain(*fc)),
            "mv_votes_control": (
                lambda fc: controls.mv_votes_control(fc[0], fc[1], geom, bnd,
                                                     shift),
                lambda fc: controls.mv_votes_control_plain(
                    fc[0], fc[1], geom, bnd, shift)),
            "mv_compute_control": (
                lambda fc: controls.mv_compute_control(*fc, *args)[0],
                lambda fc: controls.mv_compute_control_plain(*fc,
                                                             *args)[0]),
            "mv_cluster_counts": (
                lambda fc: mv_ops.mv_cluster_op(
                    fc[0], fc[1], geom, bnd, cfg.vectors_needed,
                    cfg.clusters_needed, shift)[0],
                lambda fc: mv_ops.mv_cluster_counts_plain(
                    fc[0], fc[1], geom, bnd, cfg.vectors_needed, shift))}
        res = {}
        for name, (fn, plain) in pairs.items():
            ref = [int(plain(fc).sum()) for fc in sets]
            t = audit.graph_time(fn, sets, max(64, len(sets)), ref, 3)
            if not t["checksum_ok"]:
                raise AssertionError(f"{name} {label}: graph checksum")
            res[name] = t["runs_us"]
        bound = least_time(rows * 8 + b * 8, rows * 12)
        res["bound_us"] = bound["bound_ms"] * 1e3
        # C5's, as phase 6 counts it
        c5 = least_time(first * 8 + b * 9,
                        b * (first * 12 + centre_cells(geom) * 8))
        res["c5_bound_us"] = c5["bound_ms"] * 1e3
        log(f"C3, C9, C5, K4+K5 {label} B={b} ({rows / b:.1f} MVs a "
            f"frame, frame 0 {first:.1f}, {len(sets)} buffers) on {card}: "
            f"C3 {res['mv_stream_control']} us, C9 "
            f"{res['mv_votes_control']} us, C5 "
            f"{res['mv_compute_control']} us, K4+K5 "
            f"{res['mv_cluster_counts']} us a launch (CUDA graph); C3/C9 "
            f"bound {res['bound_us']:.3f} us by {bound['bound_by']}, C5 "
            f"{res['c5_bound_us']:.3f} us by {c5['bound_by']}")
        out[label] = res
        del sets
        torch.cuda.empty_cache()
    return out


def bench_path() -> None:
    """``python -m mvtrim_tpu_torch.bench --quick``'s main, in this
    process: every line logged; the last must be its headline JSON, with
    the contract keys, a value, and every cell audited."""
    from mvtrim_tpu_torch.bench import __main__ as bench_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_main.main(["--quick"])
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"bench: {line}")
    rec = json.loads(lines[-1])
    missing = [k for k in ("metric", "value", "unit", "impl", "roofline_gbps",
                           "bytes_per_frame", "audit", "control_gbps",
                           "pct_of_control") if k not in rec]
    if (rc != 0 or missing or not rec["all_audited"] or not rec["value"]
            or rec["metric"] != "1080p_scan_frames_per_sec_per_chip"):
        raise AssertionError(f"bench --quick: rc {rc}, missing {missing}, "
                             f"all audited {rec.get('all_audited')}")
    log(f"bench --quick: {time.perf_counter() - t0:.3f} s, every cell "
        f"audited; headline {rec['value']:.0f} {rec['unit']}")


# --- phase 7 ---

PREBUILT_SCRIPT = """
import json, os, shutil, sys, time
import torch
import chip_smoke as S
from mvtrim_tpu_torch import Config, GridGeometry, oracle
from mvtrim_tpu_torch.ops import _build
from mvtrim_tpu_torch.ops import cluster as cluster_ops
from mvtrim_tpu_torch.tools import doctor

nvcc_calls = []
real_nvcc = _build._nvcc


def probe():
    nvcc_calls.append(1)
    return real_nvcc()


_build._nvcc = probe
unreachable = shutil.which("nvcc") is None and not os.path.exists(
    os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
t0 = time.perf_counter()
_build.load_library()
load_s = time.perf_counter() - t0
checks = [doctor._check_kernels(), doctor._check_kernel_cache()]
cfg = Config()
geom = GridGeometry.build(1920, 1080, cfg)
bits = torch.from_numpy(S.bits_data(int(sys.argv[1]))).cuda()
counts, motion = cluster_ops.cluster_bits_op(bits, geom, cfg.clusters_needed)
plain = cluster_ops.bits_cluster_counts_plain(bits, geom)
need = oracle.effective_clusters_needed(cfg.clusters_needed)
torch.cuda.synchronize()
print(json.dumps({
    "nvcc_unreachable": unreachable, "nvcc_calls": len(nvcc_calls),
    "built": sorted(_build.build_info), "load_s": load_s,
    "library": _build.library_path(), "checks": checks,
    "frames": int(bits.shape[0]), "motion_frames": int(motion.sum()),
    "max_abs_err": int((counts.long() - plain.long()).abs().max()),
    "motion_equal": bool(torch.equal(motion, plain >= need))}))
"""


def phase_prebuilt(seed: int) -> None:
    """7a: ``python -m mvtrim_tpu_torch.ops._build`` into a fresh
    MVT_COMPILE_CACHE, then, in a process that cannot reach ``nvcc`` (no
    PATH directory holding it, CUDA_HOME a path that does not exist) and
    the same MVT_COMPILE_CACHE: doctor's kernel-library and kernel-cache
    checks, and K1 on the seeded 1080p masks, exact against its plain
    version.  Fails if that process built anything or called ``nvcc``'s
    lookup."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ, MVT_COMPILE_CACHE=cache)
        t0 = time.perf_counter()
        built = subprocess.run(
            [sys.executable, "-m", "mvtrim_tpu_torch.ops._build", "--arch",
             _build.ARCH], cwd=here, env=env, capture_output=True,
            text=True, timeout=600)
        build_wall = time.perf_counter() - t0
        if built.returncode:
            raise AssertionError(f"ops._build exited {built.returncode}: "
                                 f"{built.stderr[-2000:]}")
        library = built.stdout.strip().splitlines()[-1]
        nvcc_s = [line for line in built.stderr.splitlines()
                  if line.startswith("built in ")]
        if os.path.dirname(library) != cache or not nvcc_s:
            raise AssertionError(f"ops._build: {library} is not a fresh "
                                 f"build in {cache}")
        env.update(CUDA_HOME=os.path.join(cache, "no-cuda"), PATH=os.pathsep
                   .join(d for d in env.get("PATH", "").split(os.pathsep)
                         if d and not os.path.exists(os.path.join(d, "nvcc"))))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", PREBUILT_SCRIPT, str(seed)], cwd=here,
            env=env, capture_output=True, text=True, timeout=300)
        run_wall = time.perf_counter() - t0
        if run.returncode:
            raise AssertionError(f"prebuilt run exited {run.returncode}: "
                                 f"{run.stderr[-2000:]}")
        rec = json.loads(run.stdout.strip().splitlines()[-1])
    for check in rec["checks"]:
        log(f"7a doctor without nvcc: {check['status']} {check['name']}: "
            f"{check['detail']}")
    log(f"7a prebuilt library {os.path.basename(library)}: "
        f"python -m mvtrim_tpu_torch.ops._build {nvcc_s[0]} by nvcc "
        f"({build_wall:.3f} s with the process's start); loaded without "
        f"nvcc in {rec['load_s'] * 1e3:.3f} ms ({run_wall:.3f} s for the "
        f"whole process); nvcc unreachable: {rec['nvcc_unreachable']}, "
        f"nvcc lookups {rec['nvcc_calls']}, built {rec['built']}; K1 on "
        f"{rec['frames']} seeded 1080p frames: max |kernel - plain| "
        f"{rec['max_abs_err']}, motion equal {rec['motion_equal']} "
        f"({rec['motion_frames']} motion frames)")
    status = {c["name"]: c["status"] for c in rec["checks"]}
    if (not rec["nvcc_unreachable"] or rec["nvcc_calls"] or rec["built"]
            or rec["library"] != library
            or status != {"kernel-library": "ok", "kernel-cache": "ok"}
            or rec["max_abs_err"] or not rec["motion_equal"]):
        raise AssertionError(f"7a: the prebuilt library run failed: {rec}")


class IntraReader(SeededReader):
    """A stand-in for an all-intra camera: its MV scans report no frame
    with MVs (empty masks, nothing counted), and its luma is
    ``LumaClip``'s, so MVT_PIPELINE=auto sends it to the SAD path."""

    def scan_bits(self, start, end, *, gw, gh, y_min, y_max, frame_skip=1,
                  max_frames=4096, timing=None, resume=False, **_):
        self._geometry(gw, gh, y_min, y_max)
        lo, hi = self._range(start, end, frame_skip, max_frames, resume)
        return (np.zeros((hi - lo, gh, (gw + 7) // 8), np.uint8),
                self.pts[lo:hi])

    def scan_luma(self, start, end, *, frame_skip=1, max_frames=256,
                  timing=None, resume=False):
        lo, hi = self._range(start, end, frame_skip, max_frames, resume)
        return luma_clip(self.seed).frames(lo, hi), self.pts[lo:hi]


@functools.lru_cache(maxsize=1)
def luma_clip(seed: int) -> LumaClip:
    return LumaClip(seed, 1920, 1080)


def watch_reader(seed: int):
    """``native.VideoReader``'s stand-in for the watch daemon: a file
    named ``mv*`` is the MV camera (``SeededReader``, 60 s of 1080p), any
    other the all-intra one (``IntraReader``, 10 s)."""
    def open_reader(path, *_args, **_kw):
        if os.path.basename(path).startswith("mv"):
            return SeededReader(seed, WATCH_MV_SEC)
        return IntraReader(seed, WATCH_INTRA_SEC)
    return open_reader


def pinned_host_mb() -> float | None:
    """Pinned host memory that PyTorch's caching host allocator holds, in
    MB; None where this PyTorch has no ``torch.cuda.host_memory_stats``."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    return stats().get("allocated_bytes.current", 0) / 2 ** 20


DAEMON_SCRIPT = """
import json, os, sys
import torch
import chip_smoke as S
from mvtrim_tpu_torch import Config, native
from mvtrim_tpu_torch.batch.batch import BatchProcessor
from mvtrim_tpu_torch.cut import executor

seed, in_dir, out_dir, samples = int(sys.argv[1]), *sys.argv[2:5]
native.VideoReader = S.watch_reader(seed)     # the probe and the workers
for wrapper, _, _ in S.KERNELS.values():
    wrapper.launches = 0
real_cut = executor.execute_cut


def launches():
    return {n: spec[0].launches for n, spec in S.KERNELS.items()}


def sampled_cut(input_path, *args, **kw):
    rc = real_cut(input_path, *args, **kw)
    with open(samples, "a") as f:
        f.write(json.dumps({
            "file": os.path.basename(input_path), "rc": rc,
            "reserved_mb": torch.cuda.memory_reserved() / 2 ** 20,
            "pinned_mb": S.pinned_host_mb()}) + "\\n")
    return rc


executor.execute_cut = sampled_cut
with open(samples, "a") as f:
    f.write(json.dumps({"file": None}) + "\\n")    # up, no CUDA use yet
rc = BatchProcessor(1, Config.from_env()).process([], out_dir, in_dir)
print(json.dumps({"rc": rc, "launches": launches()}), flush=True)
"""


def watch_refs(seed: int, workdir: str, fake: str) -> dict:
    """The oracle backend's concat list of each camera, from the pipeline
    over the same stand-in with the same cut command: camera -> (the list,
    the input path it names)."""
    refs = {}
    real = native.VideoReader
    native.VideoReader = watch_reader(seed)
    try:
        for camera in ("mv", "intra"):
            src = os.path.join(workdir, f"{camera}_ref.mp4")
            dump = os.path.join(workdir, f"{camera}_ref.concat")
            os.environ["MVT_CONCAT_DUMP"] = dump
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = ProcessingPipeline(src, src + ".out", cfg=Config(
                    scan_backend="oracle", ffmpeg_bin=fake)).run()
            with open(dump) as f:
                refs[camera] = (f.read(), src)
            log(f"7b oracle backend, {camera} camera: rc {rc}, "
                f"{refs[camera][0].count('inpoint')} segments in "
                f"{time.perf_counter() - t0:.3f} s")
            if rc != 0 or not refs[camera][0]:
                raise AssertionError(f"7b: no oracle list for {camera}")
    finally:
        native.VideoReader = real
        os.environ.pop("MVT_CONCAT_DUMP", None)
    return refs


def watch_path(seed: int):
    """7b: the port's BatchProcessor in watch mode, in a process of its
    own, fed WATCH_FILES stand-in files one at a time, alternating the MV
    and the all-intra camera, and cut by parity/fake_ffmpeg.sh, which
    dumps each concat list.  Each list must equal the oracle backend's;
    each file's list must come within WATCH_TIMEOUT; host RSS and device
    reserved memory must grow by less than 50 MB from the third file on
    (bench.soak_watch's rule).  The daemon's launch counts come back with
    its result."""
    from mvtrim_tpu_torch.bench import soak_watch

    here = os.path.dirname(os.path.abspath(__file__))
    fake = os.path.join(here, "parity", "fake_ffmpeg.sh")

    def run() -> dict:
        with tempfile.TemporaryDirectory() as workdir:
            refs = watch_refs(seed, workdir, fake)
            dirs = {k: os.path.join(workdir, k)
                    for k in ("in", "out", "lists")}
            for d in dirs.values():
                os.makedirs(d)
            samples = os.path.join(workdir, "samples.jsonl")
            env = dict(os.environ, WATCH_MODE="1", PARALLEL_STREAMS="1",
                       MVT_FFMPEG_BIN=fake, MVT_CONCAT_DUMP_DIR=dirs["lists"])
            logs = os.path.join(workdir, "daemon.log")
            with open(logs, "w") as out:
                daemon = subprocess.Popen(
                    [sys.executable, "-c", DAEMON_SCRIPT, str(seed),
                     dirs["in"], dirs["out"], samples], cwd=here, env=env,
                    stdout=out, stderr=subprocess.STDOUT, text=True)
            try:
                series = watch_feed(daemon, dirs, samples, refs, logs)
                daemon.send_signal(signal.SIGINT)
                daemon.wait(timeout=60)
            finally:
                if daemon.poll() is None:
                    daemon.kill()
                    daemon.wait()
            with open(logs) as f:
                tail = f.read().strip().splitlines()
            if daemon.returncode != 0:
                raise AssertionError(f"7b: the daemon exited "
                                     f"{daemon.returncode}: {tail[-20:]}")
            result = json.loads(tail[-1])
        growth = {k: soak_watch.steady_growth(series[k])
                  for k in ("rss_mb", "reserved_mb")}
        log(f"7b watch daemon: {WATCH_FILES} files, daemon rc "
            f"{result['rc']}; growth from the third file on {growth} MB "
            f"(limit {soak_watch.GROWTH_LIMIT_MB:g}); list latency "
            f"{[round(t, 3) for t in series['latency_s']]} s")
        if result["rc"] != 0 or not soak_watch.memory_healthy(
                {k: series[k] for k in growth}):
            raise AssertionError(f"7b: rc {result['rc']}, growth {growth}")
        return {"child_launches": result["launches"]}

    return run


def watch_feed(daemon, dirs: dict, samples: str, refs: dict,
               logs: str) -> dict:
    """Drop the files one at a time; per file, wait for its list and the
    daemon's sample, hold the list to the oracle's, and log the latency
    and memory.  Returns each series."""
    from mvtrim_tpu_torch.bench import soak_watch

    series = {k: [] for k in ("latency_s", "rss_mb", "reserved_mb",
                              "pinned_mb")}
    t0 = time.perf_counter()
    while not os.path.exists(samples) and daemon.poll() is None \
            and time.perf_counter() < t0 + WATCH_TIMEOUT:
        time.sleep(0.02)
    if not os.path.exists(samples):
        raise AssertionError(f"7b: the daemon did not start (rc "
                             f"{daemon.poll()})")
    log(f"7b daemon up in {time.perf_counter() - t0:.3f} s (imports, "
        f"before any CUDA use): host RSS "
        f"{soak_watch.rss_mb(daemon.pid):.1f} MB")
    for i in range(WATCH_FILES):
        camera = "mv" if i % 2 == 0 else "intra"
        name = f"{camera}_{i:02d}.mp4"
        staging = os.path.join(os.path.dirname(dirs["in"]), name)
        with open(staging, "wb") as f:
            f.write(b"stand-in")
        t0 = time.perf_counter()
        os.rename(staging, os.path.join(dirs["in"], name))
        listed = os.path.join(dirs["lists"], name + ".concat")
        deadline = t0 + WATCH_TIMEOUT
        latency = None
        record = None
        while time.perf_counter() < deadline and record is None:
            if latency is None and os.path.exists(listed):
                latency = time.perf_counter() - t0
            if latency is not None:
                with open(samples) as f:
                    # a line is whole once its newline is written
                    recs = [json.loads(line) for line in f
                            if line.endswith("\n")]
                record = next((r for r in recs if r["file"] == name), None)
            if daemon.poll() is not None:
                break
            time.sleep(0.02)
        if record is None:
            with open(logs) as f:
                tail = f.read().strip().splitlines()[-20:]
            raise AssertionError(f"7b: {name} not done within its time "
                                 f"(daemon rc {daemon.poll()}): {tail}")
        text, src = refs[camera]
        with open(listed) as f:
            got = f.read()
        want = text.replace(src, os.path.join(dirs["in"], name))
        rss = soak_watch.rss_mb(daemon.pid)
        for key, value in (("latency_s", latency), ("rss_mb", rss),
                           ("reserved_mb", record["reserved_mb"]),
                           ("pinned_mb", record["pinned_mb"])):
            series[key].append(value)
        pinned = ("torch.cuda.host_memory_stats not in this PyTorch"
                  if record["pinned_mb"] is None
                  else f"{record['pinned_mb']:.1f} MB")
        log(f"7b file {i} {name}: list == oracle backend's: {got == want} "
            f"({got.count('inpoint')} segments), cut rc {record['rc']}; "
            f"landing to list {latency:.3f} s; host RSS {rss:.1f} MB, "
            f"device reserved {record['reserved_mb']:.1f} MB, pinned host "
            f"{pinned}")
        if got != want or record["rc"] != 0:
            raise AssertionError(f"7b: {name}'s list differs from the "
                                 f"oracle backend's:\n{got}\n!=\n{want}")
    return series


def phase_deployment(seed: int) -> dict:
    """Phase 7: the prebuilt library without nvcc (7a), then the watch
    daemon (7b), counted; the watch path's launches."""
    phase_prebuilt(seed)
    return counted(watch_path(seed))


@contextlib.contextmanager
def launch_events():
    """Each launch of the port's kernels bracketed by two CUDA events on
    its stream (``ops/_build.launch`` wrapped): yields the list of (C entry
    point, start, end) that the launches fill in.  The stream is first
    held busy for HIDE_ENQUEUE_CYCLES, so that the kernel is queued before
    the start event runs and the pair times the kernel, not the host's
    enqueue of it."""
    real = _build.launch
    marks = []

    def timed(name, counter, device, *args):
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            torch.cuda._sleep(HIDE_ENQUEUE_CYCLES)
        start.record(stream)
        real(name, counter, device, *args)
        end.record(stream)
        marks.append((name, start, end))

    _build.launch = timed
    try:
        yield marks
    finally:
        _build.launch = real


def launch_list(us: list) -> str:
    """The first eight of a run's per-launch µs, as text."""
    return ", ".join(f"{u:.1f}" for u in us[:8]) + (", ..." if len(us) > 8
                                                   else "")


def replay_path(name: str, run: str, fields: dict, workdir: str):
    """One run of a recorded fixture: the port's ProcessingPipeline on the
    card over ``ReplayReader`` in place of ``native.VideoReader`` (the
    probe and every decode worker), cut by parity/fake_ffmpeg.sh.  Run
    twice: timed, then with CUDA events around each kernel launch for its
    device time; each concat list must equal the fixture's stored one
    (the oracle backend's on the real decode)."""
    from mvtrim_tpu_torch.utils.timing import TimingCollector

    fx = replay.load(name)

    def once(label: str, scans: list) -> tuple[float, dict]:
        src = os.path.join(workdir, f"{name}_{run}_{label}.mp4")
        dump = src + ".concat"
        metrics = src + ".jsonl"
        cfg = fx.config(**fields, ffmpeg_bin=replay.FAKE_FFMPEG,
                        metrics_json=metrics)
        class Traced(replay.ReplayReader):
            def scan_mvs(self, *args, **kw):
                scans.append(kw.get("max_mv"))
                return super().scan_mvs(*args, **kw)

        real = native.VideoReader
        native.VideoReader = lambda path, mode=native.MVT_MODE_MV: Traced(
            fx, mode, path)
        os.environ["MVT_CONCAT_DUMP"] = dump
        out = io.StringIO()
        TimingCollector.clear()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = ProcessingPipeline(src, src + ".out", cfg=cfg).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            native.VideoReader = real
            os.environ.pop("MVT_CONCAT_DUMP", None)
        got = open(dump).read() if os.path.exists(dump) else ""
        if rc != 0 or got != fx.concat(src):
            raise AssertionError(
                f"replay {name} {run} ({label}): rc {rc}, list\n{got}\n!= "
                f"the stored\n{fx.concat(src)}\n{out.getvalue()[-2000:]}")
        with open(metrics) as f:
            return wall, json.loads(f.readlines()[-1])

    def run_fn() -> dict:
        scans: list = []
        before = {k: spec[0].launches for k, spec in KERNELS.items()}
        wall, rec = once("timed", scans)
        dispatches = {k: spec[0].launches - before[k]
                      for k, spec in KERNELS.items()
                      if spec[0].launches > before[k]}
        with launch_events() as marks:
            events_wall, _ = once("event-timed", [])
        device: dict = {}
        for entry, start, end in marks:
            device.setdefault(entry, []).append(
                start.elapsed_time(end) * 1e3)
        busy = sum(map(sum, device.values())) / (events_wall * 1e6)
        log(f"replay {name} {run} ({json.dumps(fx.meta['synth'])}, "
            f"{len(fx.pts)} frames, {fx.concat_text.count('inpoint')} "
            f"segments): list == stored oracle list; wall {wall:.3f} s "
            f"(event-timed run {events_wall:.3f} s), dispatches "
            f"{dispatches}, "
            f"decision {rec['decision']} saved {rec['saved_pct']:.3f}%, "
            f"frames {rec['frames_scanned']} with MVs "
            f"{rec['frames_with_mvs']}; device µs a launch (CUDA events) "
            + ", ".join(f"{k} {sum(d):.1f} in {len(d)} ({launch_list(d)})"
                        for k, d in sorted(device.items()))
            + f"; kernels {busy * 100:.3f}% of the event-timed run's wall; "
            f"phases_us {json.dumps(rec['phases_us'])}")
        if "mvs" in fx.meta["payloads"]:
            caps = sorted(set(c for c in scans if c is not None))
            log(f"replay {name} {run}: scan_mvs capacities {caps}; "
                f"fullest frame {int(fx.arrays['mv_counts'].max())} MVs, "
                f"{int((fx.arrays['mv_counts'] > 8192).sum())} of "
                f"{len(fx.pts)} frames over 8192")
            if not caps or caps[-1] <= REPLAY_OVERFLOW_ABOVE:
                raise AssertionError(
                    f"replay {name}: no chunk re-decoded above "
                    f"{REPLAY_OVERFLOW_ABOVE} MVs ({caps})")
        return {}

    return run_fn


def phase_replay() -> dict:
    """Phase 8: every run of every recorded fixture, each counted on its
    own: path -> launches."""
    launches = {}
    with tempfile.TemporaryDirectory() as workdir:
        for name, spec in replay.FIXTURES.items():
            fx = replay.load(name)
            log(f"replay fixture {name}: {os.path.getsize(replay.path(name))}"
                f" B compressed, {fx.nbytes()} B loaded, payloads "
                f"{fx.meta['payloads']}, {fx.meta['width']}x"
                f"{fx.meta['height']} {fx.meta['duration']:.2f} s")
            for run, fields in spec.runs:
                path = f"replay_{name}_{run}"
                launches[path] = counted(replay_path(name, run, fields,
                                                     workdir))
    for (name, run), names in REPLAY_PATHS.items():
        path = f"replay_{name}_{run}"
        log(f"kernel launches in the {path} path: {launches[path]}")
        for kernel in names:
            if launches[path][kernel] == 0:
                raise AssertionError(f"the {path} path never launched "
                                     f"{kernel}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--times-only", action="store_true",
                    help="build, then time the kernels (phase 5), C1 at "
                         "phase 6's shape and C3, C5, C9 and K4+K5 at "
                         "RAGGED_TIMING, and stop "
                         "printing their times as the last line; copied "
                         "into the root of another checkout, times that "
                         "checkout's kernels on the same card")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    card, have_native = phase_environment()
    phase_build()
    if args.times_only:
        times = phase_timing(rng, args.seed, card)
        c1 = time_word_control(
            torch.Generator(device="cuda").manual_seed(args.seed + 9), card)
        ragged = time_ragged(args.seed, card)
        cells = times["word_cluster_counts"]["cells"]
        print(json.dumps({
            "times_us": {name: round(t["ms"] * 1e3, 3)
                         for name, t in times.items()},
            "c1_us": {"graph": round(c1["ms"] * 1e3, 3),
                      "torch_sum": round(c1["library_ms"] * 1e3, 3),
                      "bound": round(c1["bound_ms"] * 1e3, 3)},
            "ragged_us": ragged,
            "word_cluster": {key: {k: v for k, v in c.items()
                                   if k not in ("bound_by",)}
                             for key, c in cells.items()}}))
        return 0
    worst = {"word_cluster_counts": phase_correctness_words(rng),
             "cluster_map_counts": phase_correctness_map(rng),
             "sad_block_grid": phase_correctness_sad(rng),
             "mv_cluster_counts": phase_correctness_mv(args.seed)}
    log(f"phases 1-3 done at {time.perf_counter() - t_start:.3f} s")

    phase_doctor(have_native)
    launches = phase_main_paths(args.seed, have_native)
    archive_dispatch_times(args.seed, card)
    log(f"phase 4 done at {time.perf_counter() - t_start:.3f} s")

    times = phase_timing(rng, args.seed, card)
    log(f"phase 5 done at {time.perf_counter() - t_start:.3f} s")

    worst.update(phase_correctness_controls(args.seed))
    times.update(phase_timing_controls(args.seed, card))
    bench_launches = counted(bench_path)
    log(f"kernel launches in the bench --quick run (a graph's capture "
        f"counts each launch once, its replays not): {bench_launches}")
    for name in KERNELS:
        if bench_launches[name] == 0:
            raise AssertionError(f"the bench never launched {name}")
    log(f"phase 6 done at {time.perf_counter() - t_start:.3f} s")
    launches["watch"] = phase_deployment(args.seed)
    log(f"kernel launches in the watch path: {launches['watch']}")
    for name in PATH_KERNELS["watch"]:
        if launches["watch"][name] == 0:
            raise AssertionError(f"the watch path never launched {name}")
    log(f"phase 7 done at {time.perf_counter() - t_start:.3f} s")
    launches.update(phase_replay())
    log(f"phase 8 done at {time.perf_counter() - t_start:.3f} s")
    loaded = [m for m in sys.modules
              if m in ("jax", "mvtrim_tpu") or m.startswith(("jax.",
                                                            "mvtrim_tpu."))]
    if loaded:
        raise AssertionError(f"imported {loaded[:5]}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": bench_launches[name] + sum(
            launches[p][name] for p, names in PATH_KERNELS.items()
            if name in names),
        "max_abs_err": worst[name], "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"],
        "library_ms": times[name].get("library_ms")}
        for name, (_, source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
