"""K4+K5's least bytes and operations (``csrc/mv_cluster.cu``, the fused
raw-MV vote and cluster kernel), the yardstick of ``k45_roofline_pct``:
a frozen copy of how the program bench counts them
(``mvtrim_tpu_torch/bench/mv.py``), over the live MV rows a launch reads,
so the count stays whatever implements the rule.

Bytes: each live MV (8 bytes) read once, a frame's count (int32) read and
its motion flag and cluster count (int32) written.  Operations: about 12
integer operations an MV (two differences, two products, a sum, the
bound, two shifts, four range tests) and 8 a centre cell of a frame (the
rule's 7 and the histogram's zeroing).
"""

from __future__ import annotations

from . import roofline


def centre_cells(geom) -> int:
    """Cells of the cluster rule's centre window: rows ``[y_min, y_max)``
    inside the grid, columns ``[1, gw - 2]``."""
    rows = min(geom.y_max, geom.gh) - max(geom.y_min, 0)
    return max(rows, 0) * max(geom.gw - 2, 0)


def k45_bytes(rows: int, frames: int) -> int:
    return 8 * rows + 9 * frames


def k45_ops(rows: int, frames: int, geom) -> int:
    return 12 * rows + 8 * centre_cells(geom) * frames


def k45_least_s(rows: int, frames: int, geom) -> float:
    """The least time the card could take over ``frames`` frames holding
    ``rows`` live MVs in all."""
    return roofline.least_s(k45_bytes(rows, frames),
                            k45_ops(rows, frames, geom))
