"""The per-frame motion rule, written out plainly.

Geometry (motion_scanner.cpp:190-196): the vote grid is the frame cut
into ``BLOCK_SIZE`` squares, rounded up; ``int(gh * VERTICAL_MASK)`` rows
at the top and at the bottom are ignored.

Cluster rule (motion_scanner.cpp:277-293): a frame is motion when at
least ``max(1, CLUSTERS_NEEDED)`` active cells of the centre window (rows
``[y_min, y_max)``, columns ``[1, gw - 2]``) each have an active
4-neighbour.  A cell outside the grid reads as inactive.

Block SAD (the pixel-domain path): a block of a frame is active when the
sum of ``|luma - previous luma|`` over its in-frame pixels reaches
``ceil(MVT_SAD_THRESHOLD * BLOCK_SIZE ** 2)``; the active blocks then go
through the same cluster rule.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Geometry:
    width: int
    height: int
    block: int
    gw: int
    gh: int
    y_min: int
    y_max: int

    @classmethod
    def of(cls, width: int, height: int, knobs: dict) -> "Geometry":
        block = int(knobs["BLOCK_SIZE"])
        gw = -(-width // block)
        gh = -(-height // block)
        margin = int(gh * float(knobs["VERTICAL_MASK"]))
        return cls(width, height, block, gw, gh, margin, gh - margin)

    @property
    def mask_bytes(self) -> int:
        """Bytes of one packed activity-mask row: a bit a cell."""
        return -(-self.gw // 8)


def clusters_needed(knobs: dict) -> int:
    return max(1, int(knobs["CLUSTERS_NEEDED"]))


def unpack_masks(bits: np.ndarray, geom: Geometry) -> np.ndarray:
    """uint8 [N, gh, ceil(gw/8)], bit k of byte j the cell x = 8j + k ->
    bool [N, gh, gw]."""
    cells = np.unpackbits(bits, axis=2, bitorder="little")
    return cells[:, :, :geom.gw].astype(bool)


def pack_masks(active: np.ndarray) -> np.ndarray:
    return np.packbits(active, axis=2, bitorder="little")


def cluster_counts(active: np.ndarray, geom: Geometry) -> np.ndarray:
    """bool [N, gh, gw] -> int64 [N]: the centre window's active cells
    that have an active 4-neighbour."""
    n, gh, gw = active.shape
    pad = np.zeros((n, gh + 2, gw + 2), bool)
    pad[:, 1:-1, 1:-1] = active
    neighbour = (pad[:, 1:-1, :-2] | pad[:, 1:-1, 2:]
                 | pad[:, :-2, 1:-1] | pad[:, 2:, 1:-1])
    centre = np.zeros((gh, gw), bool)
    centre[geom.y_min:geom.y_max, 1:max(1, gw - 1)] = True
    return (active & neighbour & centre).sum(axis=(1, 2))


def sad_bound(knobs: dict) -> int:
    block = int(knobs["BLOCK_SIZE"])
    return int(math.ceil(float(knobs["MVT_SAD_THRESHOLD"]) * block * block))


def block_sad(prev: np.ndarray, cur: np.ndarray,
              geom: Geometry) -> np.ndarray:
    """uint8 [H, W] twice -> int64 [gh, gw] of block sums of |cur - prev|;
    pixels of a partial edge block outside the frame add nothing."""
    diff = np.abs(cur.astype(np.int16) - prev.astype(np.int16))
    b = geom.block
    full = np.zeros((geom.gh * b, geom.gw * b), np.int32)
    full[:geom.height, :geom.width] = diff
    return full.reshape(geom.gh, b, geom.gw, b).sum(axis=(1, 3),
                                                      dtype=np.int64)


def sad_motion(prev: np.ndarray, cur: np.ndarray, geom: Geometry,
               knobs: dict) -> bool:
    active = block_sad(prev, cur, geom) >= sad_bound(knobs)
    return bool(cluster_counts(active[None], geom)[0]
                >= clusters_needed(knobs))
