"""The one generator of traffic: a closed backlog of recordings, as a
directory batch is, drawn from a traffic file's parameters and the seed.

Every seed gets the same set of sizes in another order.  The backlog is
made of blocks of ``block_files`` files; in each block the durations, the
motion shares and the window counts are the block's evenly spaced
quantiles of their ranges, and the seed only shuffles them and places the
windows.  Parameters (lengths in seconds):

- ``files``: files in the backlog; ``block_files``: files a block;
- ``duration_s``: [lo, hi] of a file's length;
- ``no_motion_share``: files with no motion at all;
- ``copy_share``: files that show motion from end to end (the cut would
  save nothing, so they are copied whole);
- ``motion_share``: [lo, hi] of the time a motion file shows motion,
  in ``windows`` [lo, hi] windows of ``window_s`` [lo, hi] each, one to
  each equal slot of the file;
- ``warm``: ``files`` files of ``duration_s`` with one window over the
  middle fifth, the same for every seed, run in set-up.
"""

from __future__ import annotations

import os

import numpy as np

from .scene import FileSpec


def _spread(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / max(n, 1)


def _motion_windows(rng, frames: int, fps: float, share: float, k: int,
                    window_s) -> list[tuple[int, int, int]]:
    slot = frames / k
    length = share * frames / k
    length = min(max(length, window_s[0] * fps), window_s[1] * fps,
                 slot - 1)
    length = max(1, int(round(length)))
    out = []
    for i in range(k):
        first = int(i * slot + rng.uniform(0, max(0.0, slot - length)))
        out.append((first, min(first + length, frames),
                    int(rng.integers(0, 2 ** 31))))
    return out


def generate(traffic: dict, fps: float, seed: int,
             directory: str) -> list[FileSpec]:
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    total, block = int(traffic["files"]), int(traffic["block_files"])
    n_none = int(round(traffic["no_motion_share"] * block))
    n_copy = int(round(traffic["copy_share"] * block))
    n_motion = block - n_none - n_copy
    kinds = np.array(["none"] * n_none + ["copy"] * n_copy
                     + ["motion"] * n_motion)
    durations = _spread(*traffic["duration_s"], block)
    shares = _spread(*traffic["motion_share"], n_motion)
    klo, khi = traffic["windows"]
    counts = (klo + np.floor(_spread(0, khi - klo + 1, n_motion))).astype(int)
    specs = []
    while len(specs) < total:
        order_kind = rng.permutation(kinds)
        order_dur = rng.permutation(durations)
        order_share = rng.permutation(shares)
        order_count = rng.permutation(counts)
        m = 0
        for kind, dur in zip(order_kind, order_dur):
            frames = int(round(dur * fps))
            if kind == "none":
                windows = []
            elif kind == "copy":
                windows = [(0, frames, int(rng.integers(0, 2 ** 31)))]
            else:
                windows = _motion_windows(rng, frames, fps, order_share[m],
                                          int(order_count[m]),
                                          traffic["window_s"])
                m += 1
            name = os.path.join(directory, f"cam{len(specs):06d}.mp4")
            specs.append(FileSpec(name, frames, fps, tuple(windows)))
            if len(specs) == total:
                break
    return specs


def warm(traffic: dict, fps: float, directory: str) -> list[FileSpec]:
    w = traffic["warm"]
    frames = int(round(w["duration_s"] * fps))
    window = ((2 * frames // 5, 3 * frames // 5, 0),)
    return [FileSpec(os.path.join(directory, f"warm{i}.mp4"), frames, fps,
                     window) for i in range(int(w["files"]))]
