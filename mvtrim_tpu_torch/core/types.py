"""Core value types (reference include/motion_trim/types.hpp:33-96).

The reference's ``PaddedAtomic``/cache-line games exist to serve a scalar CPU
hot loop; on TPU the hot loop is a batched kernel, so only the semantic types
survive: time segments, scan tasks, and the grid geometry bundle consumed by
the device kernels.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TimeSegment:
    """Half-open-ish [start, end] segment in seconds (types.hpp:56-62)."""

    start: float
    end: float

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)


@dataclasses.dataclass(frozen=True)
class ScanTask:
    """A chunk of the video timeline to scan (types.hpp:88-96)."""

    start: float
    end: float
    chunk_id: int


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static per-video geometry baked into jit'd scan programs.

    gw/gh: vote-grid dims (frame dims ceil-divided by block size);
    y_min/y_max: vertical mask window (motion_scanner.cpp:237-238);
    padded dims are the TPU lane/sublane-aligned extents.
    """

    width: int
    height: int
    gw: int
    gh: int
    y_min: int
    y_max: int

    @classmethod
    def build(cls, width: int, height: int, cfg) -> "GridGeometry":
        gw, gh = cfg.grid_dims(width, height)
        margin = cfg.vertical_margin(gh)
        return cls(width=width, height=height, gw=gw, gh=gh,
                   y_min=margin, y_max=gh - margin)

    @property
    def padded_gw(self) -> int:
        return _round_up(self.gw, 128)

    @property
    def padded_gh(self) -> int:
        return _round_up(self.gh, 8)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
