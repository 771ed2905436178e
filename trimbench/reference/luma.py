"""The pixel-domain scan over decoded luma (``scan_luma``): frame i
against frame i - 1 by block SAD and the cluster rule, never at a scan
chunk's first frame, which has no predecessor."""

from __future__ import annotations

import numpy as np

from . import rule


class Decider:
    def __init__(self, pool: np.ndarray, geom: rule.Geometry, knobs: dict):
        self.pool, self.geom, self.knobs = pool, geom, knobs
        self.known: dict[tuple[int, int], bool] = {}

    def pair(self, prev: int, cur: int) -> bool:
        """Motion of pool entry ``cur`` after ``prev``, worked out when
        first asked for."""
        key = (prev, cur)
        if key not in self.known:
            self.known[key] = rule.sad_motion(
                self.pool[prev], self.pool[cur], self.geom, self.knobs)
        return self.known[key]

    def __call__(self, index: np.ndarray, firsts: np.ndarray) -> np.ndarray:
        out = np.zeros(len(index), bool)
        if len(index) < 2:
            return out
        keys = index[:-1].astype(np.int64) * (1 << 32) + index[1:]
        uniq, inverse = np.unique(keys, return_inverse=True)
        decided = np.array([self.pair(int(k >> 32), int(k & 0xFFFFFFFF))
                            for k in uniq], bool)
        out[1:] = decided[inverse]
        out[firsts] = False
        return out
