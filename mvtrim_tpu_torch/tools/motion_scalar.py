"""motion_scalar — per-second motion scalar from an extract_mvs JSON dump.

Reference parity (tools/motion_scalar.cpp:38-123): for every frame with a
non-null pts, each MV contributes ``|motion/scale| * w * h`` (sub-pel
magnitude times block area) to the bucket for floor(pts); MVs with
motion_scale == 0 are skipped.  Output: ``second,motion_value`` CSV on
stdout plus rusage performance metrics on stderr.

Usage: python -m mvtrim_tpu_torch.tools.motion_scalar motion_vectors.json
"""

from __future__ import annotations

import json
import math
import resource
import sys
import time
from collections import defaultdict


def motion_per_second(doc: dict) -> dict[int, float]:
    buckets: dict[int, float] = defaultdict(float)
    for frame in doc["frames"]:
        pts = frame.get("pts_seconds")
        if pts is None:
            continue
        sec = int(math.floor(pts))
        for mv in frame["motion_vectors"]:
            scale = mv["motion_scale"]
            if scale == 0:
                continue
            dx = mv["motion_x"] / scale
            dy = mv["motion_y"] / scale
            buckets[sec] += math.sqrt(dx * dx + dy * dy) * mv["w"] * mv["h"]
    return dict(buckets)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("Usage: motion_scalar motion_vectors.json", file=sys.stderr)
        return 1

    wall_start = time.perf_counter()
    ru_start = resource.getrusage(resource.RUSAGE_SELF)

    with open(argv[0]) as f:
        doc = json.load(f)
    buckets = motion_per_second(doc)

    wall = time.perf_counter() - wall_start
    ru_end = resource.getrusage(resource.RUSAGE_SELF)
    user = ru_end.ru_utime - ru_start.ru_utime
    sys_t = ru_end.ru_stime - ru_start.ru_stime
    cpu = user + sys_t

    print("second,motion_value")
    for sec, value in buckets.items():
        print(f"{sec},{value:g}")

    print("\n==== PERFORMANCE METRICS ====", file=sys.stderr)
    print(f"Wall time (s):        {wall:g}", file=sys.stderr)
    print(f"User CPU time (s):    {user:g}", file=sys.stderr)
    print(f"System CPU time (s):  {sys_t:g}", file=sys.stderr)
    print(f"Total CPU time (s):   {cpu:g}", file=sys.stderr)
    print(f"CPU utilization (%): {cpu / wall * 100 if wall else 0:g}",
          file=sys.stderr)
    print(f"Max RSS (MB):         {ru_end.ru_maxrss / 1024:g}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
