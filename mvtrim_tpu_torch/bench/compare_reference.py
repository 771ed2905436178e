"""Head to head: the port against the compiled C++ reference.

The counterpart of the JAX package's ``benchmarks/compare_reference.py``.
Builds the reference (``parity/harness.py``'s ``ensure_reference``, which
needs its checkout, ``MVT_REFERENCE_DIR``), synthesizes a clip, runs both
implementations on it end to end with each cut captured by a stand-in
(``parity/fake_ffmpeg.sh`` for ``python -m mvtrim_tpu_torch``, the
``system()`` interposer for the reference), so only scan and segmentation
are timed; requires the two concat lists to be byte-identical and prints
the comparison as JSON.

    python -m mvtrim_tpu_torch.bench.compare_reference [--duration 120]
        [--runs 2] [--width 1920] [--height 1080]

The port's backend follows MVT_SCAN_BACKEND (``auto``: the card).
``marginal_per_video_sec`` excludes the port's kernel build or load
(``warmup(build)``), which a daemon or batch pays once; ``wall_sec``
includes it and the interpreter's start.  Exit 0 when the lists are
identical.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from statistics import median

from ..io import native

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FAKE_FFMPEG = os.path.join(_ROOT, "parity", "fake_ffmpeg.sh")
BUILD_DIR = os.path.join(_ROOT, "build", "reference")


def harness():
    """``parity/harness.py`` of this checkout (the reference's build and
    run; no module of the JAX package)."""
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    from parity import harness as h
    return h


def run_ours(input_arg: str, output_arg: str, dump: str,
             env_knobs: dict | None = None, timeout: int = 3600):
    """``python -m mvtrim_tpu_torch`` with the list-capturing ffmpeg
    stand-in: (wall seconds, the concat list or None, stdout)."""
    if os.path.exists(dump):
        os.unlink(dump)
    env = dict(os.environ, **(env_knobs or {}), MVT_FFMPEG_BIN=FAKE_FFMPEG,
               MVT_CONCAT_DUMP=dump)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mvtrim_tpu_torch", input_arg, output_arg],
        env=env, cwd=_ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"the port failed: {res.stdout}{res.stderr}")
    concat = open(dump).read() if os.path.exists(dump) else None
    return wall, concat, res.stdout


def phase_seconds(stdout: str, name: str) -> float | None:
    """A phase's seconds in the port's timing summary."""
    m = re.search(rf"{re.escape(name)}\s+([0-9.]+)s", stdout)
    return float(m.group(1)) if m else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)
    h = harness()
    binary, shim = h.ensure_reference(BUILD_DIR)

    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.mp4")
        d = args.duration
        print(f"synthesizing {d:.0f}s {args.width}x{args.height} clip...",
              file=sys.stderr)
        native.synthesize(clip, width=args.width, height=args.height,
                          fps=25.0, duration=d, codec="libx264",
                          motion_windows=((d * 0.1, d * 0.2),
                                          (d * 0.5, d * 0.65),
                                          (d * 0.85, d * 0.9)))
        # reference and port in turns: the host's throughput drifts over
        # minutes, so pairs run back to back compare fairly
        ref_walls, ref_concat = [], None
        our_walls, our_marginals, our_concat = [], [], None
        for i in range(args.runs):
            print(f"run {i + 1}/{args.runs}: reference...", file=sys.stderr)
            wall, ref_concat = h.run_reference(
                binary, shim, clip, os.path.join(tmp, "ref_out.mp4"),
                os.path.join(tmp, "ref_concat.txt"))
            ref_walls.append(wall)
            print(f"run {i + 1}/{args.runs}: port...", file=sys.stderr)
            wall, our_concat, stdout = run_ours(
                clip, os.path.join(tmp, "our_out.mp4"),
                os.path.join(tmp, "our_concat.txt"), {"MVT_LOG": "0"})
            our_walls.append(wall)
            total = phase_seconds(stdout, "total_run") or wall
            our_marginals.append(
                total - (phase_seconds(stdout, "warmup(build)") or 0.0))

    frames = args.duration * 25.0
    ref_med, our_med = median(ref_walls), median(our_marginals)
    result = {
        "clip": {"resolution": f"{args.width}x{args.height}",
                 "duration_sec": args.duration, "frames": frames},
        "reference_cpp": {
            "wall_sec": round(ref_med, 2),
            "wall_sec_runs": [round(w, 2) for w in ref_walls],
            "frames_per_sec": round(frames / ref_med),
        },
        "port_torch": {
            "wall_sec": round(median(our_walls), 2),
            "marginal_per_video_sec": round(our_med, 2),
            "marginal_per_video_runs": [round(w, 2) for w in our_marginals],
            "marginal_frames_per_sec": round(frames / our_med),
        },
        "port_vs_reference": round(ref_med / our_med, 3),
        "concat_lists_identical": (our_concat is not None
                                   and our_concat == ref_concat),
    }
    print(json.dumps(result, indent=2))
    return 0 if result["concat_lists_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
