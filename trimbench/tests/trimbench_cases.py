"""Cells cut down to a size the CPU tests can run: a 320x192 camera, short
files, the program's plain PyTorch build (MVT_SCAN_BACKEND=torch)."""

from __future__ import annotations

import copy
import time

from trimbench import harness, spec

CPU_ENV = {"MVT_SCAN_BACKEND": "torch"}

# cells whose configuration and mix stay under trimbench/ for a later
# benchmark, not yet in BENCHMARK.json; the CPU tests keep their path whole
LATER = [{"name": "sad1080_nvr", "config": "cctv1080_intra",
          "traffic": "nvr_40to120s", "chips": 1},
         {"name": "sad1080_events", "config": "cctv1080_intra",
          "traffic": "events_10to30s", "chips": 1}]


def small_cell(name: str, files: int = 24) -> spec.Cell:
    bench = spec.load_benchmark()
    known = {w["name"] for w in bench["workloads"]}
    bench = dict(bench, workloads=bench["workloads"]
                 + [w for w in LATER if w["name"] not in known])
    cell = spec.cell(name, bench)
    cell.config = copy.deepcopy(cell.config)
    cell.config["camera"].update(width=320, height=192)
    luma = cell.config["scene"].get("luma")
    if luma:
        for obj in luma["objects"]:
            obj.update(h=min(obj["h"], 60), w=min(obj["w"], 40),
                       speed_px=min(obj["speed_px"], 3))
    lo, hi = cell.traffic["duration_s"]
    scale = 10.0 if hi > 100 else 1.0
    cell.traffic = dict(cell.traffic, files=files,
                        duration_s=[lo / scale, hi / scale],
                        warm={"files": 1, "duration_s": 12})
    return cell


def run_small(name: str, seed: int = 20261017, seconds: float = 30.0,
              files: int = 24) -> dict:
    """A whole run of the small cell on the CPU; the backlog is short
    enough to end before ``seconds``."""
    return harness.run_cell(small_cell(name, files), seed, seconds, False,
                            t_start=time.perf_counter(), require_cuda=False,
                            env=CPU_ENV)
