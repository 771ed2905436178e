"""The MV scan over packed activity masks (``scan_bits``): each frame by
the cluster rule over its own mask."""

from __future__ import annotations

import numpy as np

from . import rule


class Decider:
    def __init__(self, pool: np.ndarray, geom: rule.Geometry, knobs: dict):
        counts = rule.cluster_counts(rule.unpack_masks(pool, geom), geom)
        self.motion = counts >= rule.clusters_needed(knobs)

    def __call__(self, index: np.ndarray, firsts: np.ndarray) -> np.ndarray:
        """bool [n] of a file whose frame i is pool entry index[i]."""
        return self.motion[index]
