"""python -m mvtrim_tpu_torch.bench.dispatch_batch [--videos V] [--frames F]
    [--width W --height H] [--repeats R] [--density D] [--device cuda|cpu]

Would merging many small videos' scan batches into shared dispatches pay?
The port's counterpart of ``benchmarks/dispatch_batch_bench.py``: V videos
of F frames of seeded bits masks go through ``scan_bits_async`` in three
ways, each timed by the host clock (median of R):

* ``pervideo``: each video dispatches and resolves before the next, as one
  pipeline a video does;
* ``pipelined``: every video's dispatch issued back to back, one resolve
  pass at the end;
* ``merged``: one call over all V * F frames (ceil(V * F / device_batch)
  dispatches).

All three must give the same motion, equal to the NumPy oracle's.  On the
card unless ``--device cpu`` (the plain PyTorch build, labelled
``cpu-plain``); without a card and without ``--device cpu`` it exits 2.
One line a strategy on standard error and, as the last line of standard
output, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..core import oracle
from ..core.config import Config
from ..models.mv_detector import MVClusterDetector
from . import audit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mvtrim_tpu_torch.bench.dispatch_batch",
        description="Per-video, pipelined and merged dispatch of small "
                    "videos' scan batches.")
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--density", type=float, default=0.03)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mvtrim_tpu_torch.bench.dispatch_batch: no CUDA device; pass "
              "--device cpu for the CPU build", file=sys.stderr)
        return 2
    card = audit.CPU_LABEL if args.device == "cpu" else audit.card_name()
    cfg = Config(scan_backend="auto" if args.device == "cuda" else "torch")
    det = MVClusterDetector(args.width, args.height, cfg)
    geom = det.geom
    v, f = args.videos, args.frames

    rng = np.random.default_rng(7)
    active = rng.random((v, f, geom.gh, geom.gw)) < args.density
    bits = np.packbits(active, axis=3, bitorder="little")  # [V, F, gh, gwb]
    merged_bits = bits.reshape(v * f, geom.gh, -1)
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    truth = np.stack([
        oracle.count_clusters_batch(active[i].astype(np.uint8),
                                    vectors_needed=1, y_min=geom.y_min,
                                    y_max=geom.y_max) >= need
        for i in range(v)])

    det.scan_bits(bits[0])  # warm-up: build, first launch, allocator

    def pervideo():
        return np.stack([det.scan_bits_async(bits[i])() for i in range(v)])

    def pipelined():
        resolvers = [det.scan_bits_async(bits[i]) for i in range(v)]
        return np.stack([r() for r in resolvers])

    def merged():
        return det.scan_bits_async(merged_bits)().reshape(v, f)

    strategies = (("pervideo", pervideo, v), ("pipelined", pipelined, v),
                  ("merged", merged, -(-(v * f) // det.device_batch)))
    results = {}
    for name, fn, dispatches in strategies:
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            motion = fn()
            times.append(time.perf_counter() - t0)
        if not np.array_equal(motion, truth):
            raise AssertionError(f"{name} differs from the oracle")
        med = statistics.median(times)
        results[name] = {"median_s": med, "dispatches": dispatches,
                         "per_dispatch_ms": 1e3 * med / dispatches}
        print(f"{name:<10} {med * 1e3:8.3f} ms   {dispatches:3d} dispatches"
              f"   {1e3 * med / dispatches:7.3f} ms a dispatch on {card}",
              file=sys.stderr)
    rec = {"bench": "dispatch_batch", "videos": v, "frames_per_video": f,
           "width": args.width, "height": args.height,
           "device_batch": det.device_batch, "backend": det.backend,
           "platform": args.device, "card": card, "decode": "excluded",
           "audit": "all strategies bit-equal the oracle motion vector",
           "merged_saves_s_per_batch":
               results["pervideo"]["median_s"] - results["merged"]["median_s"],
           **results}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
