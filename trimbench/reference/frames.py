"""Frame times and the scan's chunks, as the upstream pipeline cuts a
file (pipeline.cpp:127-295): chunks of ``CHUNK_DURATION_SEC``, the frames
with pts in ``[t, t + chunk)``.  A file's frames are drawn from a pool:
``index[i]`` is the pool entry served as frame ``i``; a payload's module
here (``bits``, ``luma``) decides a file from its index and its chunks'
first frames.  The capped sub-scans inside a chunk carry their last
frame, so they change nothing and the reference knows nothing of them.
"""

from __future__ import annotations

import numpy as np


def pts_of(n: int, fps: float) -> np.ndarray:
    return np.arange(n) / fps


def chunk_firsts(n: int, fps: float, chunk_s: float) -> np.ndarray:
    """bool [n]: the first frame of each scan chunk."""
    pts = pts_of(n, fps)
    duration = n / fps
    first = np.zeros(n, bool)
    t = 0.0
    while t < duration:
        i = int(np.searchsorted(pts, t, side="left"))
        if i < n:
            first[i] = True
        t += chunk_s
    return first
