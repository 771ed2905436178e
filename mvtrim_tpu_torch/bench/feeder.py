"""python -m mvtrim_tpu_torch.bench.feeder [--payload bits,words]
    [--producers 1,2,4,8,16,32] [--frames N] [--chunk F]
    [--dispatch null|device] [--width W --height H] [--device-batch B]
    [--device cuda|cpu]

Can one Python feeder keep up with many decode threads?  The port's
counterpart of ``benchmarks/feeder_bench.py``: N producer threads hand
pre-decoded chunks (seeded masks at a sparse 3% activity, no decode cost)
to one feeder that dispatches them through ``MVClusterDetector``'s
``scan_bits_async`` / ``scan_words_async``, and frames/s is what the
feeder sustains, decode excluded.

* ``--dispatch device``: the real dispatch, on the card (pinned staging,
  the H2D copy, K1, the motion copied back) and every resolver read.
* ``--dispatch null``: the same batch assembly and staging with the
  kernel replaced by a stub that returns no motion, so the feeder's own
  host work is measured.

On the card unless ``--device cpu`` (the plain PyTorch build on the CPU,
labelled ``cpu-plain``); without a card and without ``--device cpu`` it
exits 2.  One line a case on standard error and, as the last line of
standard output, one JSON object with every case.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time

import numpy as np
import torch

from ..core.config import Config
from ..models.mv_detector import MVClusterDetector
from ..ops.cluster import repack_bits_words
from . import audit


def make_chunks(payload: str, geom, chunk_frames: int, n_distinct: int = 8,
                seed: int = 0) -> list:
    """Pre-decoded chunk payloads with sparse activity, and their pts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_distinct):
        active = rng.random((chunk_frames, geom.gh, geom.gw)) < 0.03
        bits = np.packbits(active, axis=2, bitorder="little")
        pts = np.arange(chunk_frames, dtype=np.float64) / 25.0
        data = bits if payload == "bits" else np.ascontiguousarray(
            repack_bits_words(bits, geom))
        out.append((data, pts))
    return out


def detector(width: int, height: int, device_batch: int, device: str,
             dispatch: str) -> MVClusterDetector:
    """The feeder's detector: on the card (auto) or the CPU build (torch);
    with ``dispatch == "null"`` its ops return no motion and launch
    nothing."""
    cfg = Config(device_batch=device_batch,
                 scan_backend="auto" if device == "cuda" else "torch")
    det = MVClusterDetector(width, height, cfg)
    if dispatch == "null":
        def null_op(batch: torch.Tensor) -> torch.Tensor:
            return torch.zeros((batch.shape[0],), dtype=torch.bool,
                               device=batch.device)

        det._bits_op = det._words_op = null_op
    return det


def run_case(det: MVClusterDetector, payload: str, n_producers: int,
             total_frames: int, chunk_frames: int) -> tuple:
    """(frames/s, frames, motion frames) of one feeder over n_producers
    producer threads."""
    chunks = make_chunks(payload, det.geom, chunk_frames)
    n_chunks = (total_frames + chunk_frames - 1) // chunk_frames
    # the remainder spread over the producers, not dropped
    per_producer = [n_chunks // n_producers + (i < n_chunks % n_producers)
                    for i in range(n_producers)]
    results: queue.Queue = queue.Queue(maxsize=max(4, 2 * n_producers))

    def producer(widx: int) -> None:
        for i in range(per_producer[widx]):
            results.put(chunks[(widx + i) % len(chunks)])
        results.put(None)

    scan = det.scan_bits_async if payload == "bits" else det.scan_words_async
    threads = [threading.Thread(target=producer, args=(i,))
               for i in range(n_producers)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    pending, frames, done = [], 0, 0
    while done < n_producers:
        item = results.get()
        if item is None:
            done += 1
            continue
        data, pts = item
        pending.append(scan(data))
        frames += len(pts)
    motion = sum(int(resolve().sum()) for resolve in pending)
    for th in threads:
        th.join()
    return frames / (time.perf_counter() - t0), frames, motion


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mvtrim_tpu_torch.bench.feeder",
        description="Frames/s one feeder sustains over producer threads.")
    ap.add_argument("--payload", default="bits,words")
    ap.add_argument("--producers", default="1,2,4,8,16,32")
    ap.add_argument("--frames", type=int, default=40000)
    ap.add_argument("--chunk", type=int, default=256,
                    help="frames a producer chunk")
    ap.add_argument("--dispatch", default="null", choices=("null", "device"))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device-batch", type=int, default=2048)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mvtrim_tpu_torch.bench.feeder: no CUDA device; pass --device "
              "cpu for the CPU build", file=sys.stderr)
        return 2
    card = audit.CPU_LABEL if args.device == "cpu" else audit.card_name()
    det = detector(args.width, args.height, args.device_batch, args.device,
                   args.dispatch)
    # warm-up: the kernel build, the first launch and the allocator, outside
    # every timed case
    gwb = (det.geom.gw + 7) // 8
    det.scan_bits(np.zeros((1, det.geom.gh, gwb), np.uint8))
    rows = []
    for payload in args.payload.split(","):
        for n in (int(x) for x in args.producers.split(",")):
            fps, frames, motion = run_case(det, payload, n, args.frames,
                                           args.chunk)
            print(f"feeder {payload} {n} producers ({args.dispatch} "
                  f"dispatch): {fps:,.0f} frames/s over {frames} frames on "
                  f"{card}", file=sys.stderr)
            rows.append({"payload": payload, "producers": n,
                         "frames_per_sec": fps, "frames": frames,
                         "motion_frames": motion})
    print(json.dumps({"bench": "feeder", "dispatch": args.dispatch,
                      "device": args.device, "card": card,
                      "width": args.width, "height": args.height,
                      "chunk": args.chunk,
                      "device_batch": args.device_batch,
                      "decode": "excluded", "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
