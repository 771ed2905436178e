"""The card's peaks and the kernels' least bytes, the yardstick of the
roofline metrics.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 3.35 TB/s of
HBM and 67 T/s of float32 operations outside the tensor cores, the
nearest entry for the kernels' 32-bit integer operations.  Bytes count
each byte a kernel's function needs read once and each output written
once (a frozen copy of the program bench's ``audit.rows_bytes``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def least_s(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


def cluster_rows(geom) -> int:
    """Rows a cluster kernel's counts depend on: the centre window and
    one row on each side, inside the grid."""
    lo, hi = max(geom.y_min, 0), min(geom.y_max, geom.gh)
    return 0 if hi <= lo else min(hi + 1, geom.gh) - max(lo - 1, 0)


def k1_bytes_per_frame(geom) -> int:
    """K1 (word cluster over packed masks at their own pitch): the rows
    read, a count (int32) and a motion flag written."""
    return cluster_rows(geom) * geom.mask_bytes + 5


def k1_ops_per_frame(geom) -> int:
    """About 16 integer operations a 32-cell word of those rows."""
    return cluster_rows(geom) * -(-geom.gw // 32) * 16


def k6_bytes(geom, comparisons: int, launches: int) -> int:
    """K6 (block SAD) over ``comparisons`` frame pairs in ``launches``
    windows: each window reads its frames and the one before them once,
    and writes an int32 grid a comparison."""
    plane = geom.width * geom.height
    return (comparisons + launches) * plane + comparisons * geom.gh * geom.gw * 4


def k6_ops(geom, comparisons: int) -> int:
    """A subtraction and an add a pixel a comparison."""
    return comparisons * geom.width * geom.height * 2
