"""The MV scan over raw motion vectors (``scan_mvs``): each frame by the
upstream vote and cluster rule over its complete MV list.

Per MV (motion_scanner.cpp:242-268): the magnitude ``(dst_x - src_x)² +
(dst_y - src_y)²``, formed wide and wrapped to 32 bits as the upstream's
``int`` wraps; the MV is kept at or over ``ceil(MV_THRESHOLD_SQ)``; its
cell is ``(dst_x >> BLOCK_SHIFT, dst_y >> BLOCK_SHIFT)``, arithmetic
shifts, so a negative ``dst`` lands left of or above the grid; a kept MV
inside ``0 <= gx < gw``, ``y_min <= gy < y_max`` votes once in its cell,
the votes saturating at 255.  A cell is active at ``VECTORS_NEEDED``
votes; then the cluster rule (``rule.cluster_counts``); a frame is motion
when it carries MVs and at least ``max(1, CLUSTERS_NEEDED)`` of its centre
cells are clustered.

Departures from motion_scanner.cpp, none of which changes a decision:
the magnitude is compared with the integer ``ceil`` of the threshold
where the upstream compares it with the double (equal for integer
magnitudes); the cluster count has no early exit; a neighbour outside the
grid reads as inactive (the upstream reads rows ``y_min - 1`` and
``y_max``, which exist and hold no votes whenever the grid masks a row,
and is undefined where it masks none); a frame without MVs is not motion
(the upstream returns before voting when a frame has no MV side data, and
FFmpeg never attaches an empty list).

Every pool entry is decided once, when the decider is made; a file is
then a lookup.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

from . import rule

# pool entries voted at once (bounds the wide intermediates)
BLOCK = 16


def magnitude(fields: np.ndarray) -> np.ndarray:
    """int16 [..., 4] -> the int32 wrap of the int64 squared magnitude,
    as int64."""
    f = fields.astype(np.int64)
    dx = f[..., 0] - f[..., 2]
    dy = f[..., 1] - f[..., 3]
    return (dx * dx + dy * dy + (1 << 31)) % (1 << 32) - (1 << 31)


def votes(fields: np.ndarray, counts: np.ndarray, geom: rule.Geometry,
          knobs: dict) -> np.ndarray:
    """int16 [E, P, 4] + counts [E] -> int64 [E, gh, gw] of votes,
    saturated at 255, over the first ``counts[e]`` MVs of each entry."""
    bound = math.ceil(float(knobs["MV_THRESHOLD_SQ"]))
    shift = int(knobs["BLOCK_SHIFT"])
    e, p = fields.shape[:2]
    f = fields.astype(np.int64)
    gx = f[..., 0] >> shift
    gy = f[..., 1] >> shift
    keep = ((np.arange(p)[None, :] < np.asarray(counts)[:, None])
            & (magnitude(fields) >= bound)
            & (gx >= 0) & (gx < geom.gw)
            & (gy >= geom.y_min) & (gy < geom.y_max))
    entry = np.broadcast_to(np.arange(e)[:, None], keep.shape)
    flat = (entry[keep] * geom.gh + gy[keep]) * geom.gw + gx[keep]
    cells = np.bincount(flat, minlength=e * geom.gh * geom.gw)
    return np.minimum(cells, 255).reshape(e, geom.gh, geom.gw)


def decide(fields: np.ndarray, counts: np.ndarray, geom: rule.Geometry,
           knobs: dict) -> np.ndarray:
    """bool [E]: each entry's motion."""
    counts = np.asarray(counts)
    motion = np.zeros(len(counts), bool)
    for lo in range(0, len(counts), BLOCK):
        hi = min(lo + BLOCK, len(counts))
        active = votes(fields[lo:hi], counts[lo:hi], geom,
                       knobs) >= int(knobs["VECTORS_NEEDED"])
        clustered = rule.cluster_counts(active, geom)
        motion[lo:hi] = ((clustered >= rule.clusters_needed(knobs))
                         & (counts[lo:hi] > 0))
    return motion


class Decider:
    def __init__(self, pool, geom: rule.Geometry, knobs: dict):
        fields, counts = pool
        self.motion = decide(fields, counts, geom, knobs)

    def __call__(self, index: np.ndarray, firsts: np.ndarray) -> np.ndarray:
        """bool [n] of a file whose frame i is pool entry index[i]."""
        return self.motion[index]
