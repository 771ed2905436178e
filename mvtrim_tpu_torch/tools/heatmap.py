"""heatmap — spatial motion-frequency map for a video.

The reference's motion_scalar tool answers "when is there motion"
(per-second scalars); this answers "where": for every 16x16 grid cell, the
fraction of analyzed frames in which the cell was active (votes >=
VECTORS_NEEDED), accumulated over the same vote grids the detector
scans — analytics ride the scan pipeline's grids directly.

Usage:
  python -m mvtrim_tpu_torch.tools.heatmap input.mp4 [-o heatmap.json] \\
      [--npy out.npy]

JSON output: grid dims, frames analyzed, per-cell activity fractions
(rounded), and the hottest cells.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from ..core.config import Config
from ..core.types import GridGeometry
from ..io import native


def compute_heatmap(input_path: str, cfg: Config | None = None):
    """Returns (activity [gh, gw] float64 in [0,1], frames_analyzed, geom)."""
    cfg = cfg or Config.from_env()
    reader = native.VideoReader(input_path)
    geom = GridGeometry.build(reader.width, reader.height, cfg)
    frame_skip = cfg.frame_skip(reader.fps)
    duration = reader.duration

    # NumPy accumulation: chunk frame counts vary (tails, cap resumes), so
    # a jitted reduction would retrace per distinct shape — and the grids
    # are tiny, so the host sum is effectively free.
    def accumulate(acc, grids):
        active = grids >= cfg.vectors_needed
        return acc + active.sum(axis=0, dtype=np.int64)

    acc = np.zeros((geom.gh, geom.gw), np.int64)
    frames = 0
    cap = int(math.ceil(cfg.chunk_duration_sec * max(reader.fps, 1.0))) + 64
    cur = native.ChunkScanCursor(duration, cfg.chunk_duration_sec, cap)
    # VECTORS_NEEDED <= 0 makes every cell of a ZERO grid "active"
    # (votes >= 0) — reference-consistent for frames that carried MV side
    # data, but MV-less frames must stay inactive (unconditional
    # ``!sd -> false``, motion_scanner.cpp:219-221).  plain scan_grids
    # cannot distinguish the two, so take the has_mv channel.
    vec0 = cfg.vectors_needed <= 0
    while cur.more():
        start, end = cur.window()
        if vec0:
            multi, pts, has_mv = reader.scan_grids_multi(
                start, end, thresholds_sq=[cfg.mv_threshold_sq],
                block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
                y_min=geom.y_min, y_max=geom.y_max,
                frame_skip=frame_skip, max_frames=cap, resume=cur.resume)
            grids = multi[:, 0][has_mv]  # MV-less frames: no activity
        else:
            grids, pts = reader.scan_grids(
                start, end, threshold_sq=cfg.mv_threshold_sq,
                block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
                y_min=geom.y_min, y_max=geom.y_max,
                frame_skip=frame_skip, max_frames=cap, resume=cur.resume)
        if len(pts):
            if len(grids):
                acc = accumulate(acc, grids)
            frames += len(pts)  # MV-less frames stay in the denominator
        cur.advance(len(pts))
    reader.close()

    counts = np.asarray(acc, dtype=np.float64)
    activity = counts / frames if frames else counts
    return activity, frames, geom


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="heatmap")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", default=None,
                        help="JSON output path (default: stdout)")
    parser.add_argument("--npy", default=None,
                        help="also save the raw activity matrix as .npy")
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args(argv)

    cfg = Config.from_env()
    activity, frames, geom = compute_heatmap(args.input, cfg)
    if args.npy:
        np.save(args.npy, activity)

    bs = cfg.block_size
    flat = activity.ravel()
    order = np.argsort(flat)[::-1][:args.top]
    hottest = [{
        "cell": [int(i // geom.gw), int(i % geom.gw)],          # [row, col]
        "pixel_xy": [int(i % geom.gw) * bs, int(i // geom.gw) * bs],
        "activity": round(float(flat[i]), 4),
    } for i in order if flat[i] > 0]

    doc = {
        "input": args.input,
        "grid": [geom.gh, geom.gw],
        "frames_analyzed": frames,
        "mean_activity": round(float(activity.mean()), 6),
        "max_activity": round(float(activity.max()), 4),
        "hottest_cells": hottest,
        "activity": [[round(float(v), 4) for v in row] for row in activity],
    }
    text = json.dumps(doc)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
