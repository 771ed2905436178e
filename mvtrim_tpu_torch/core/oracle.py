"""Bit-parity oracle: the reference's analysis math in plain NumPy.

This module freezes the exact semantics of the C++ hot loops so the Pallas /
XLA kernels can be tested against it:

* ``vote_grid``      — reference motion_scanner.cpp:242-268 (phase 1)
* ``count_clusters`` — reference motion_scanner.cpp:277-293 (phase 2)
* ``check_frame``    — reference motion_scanner.cpp:217-295
* ``segments_from_timestamps`` — reference pipeline.cpp:302-356
* ``savings``        — reference pipeline.cpp:349-356
* ``format_cut_point`` — the ``{:.2f}`` inpoint/outpoint contract
  (pipeline.cpp:464-470) that defines the final cut boundaries.

Everything here is deliberately slow and obvious; it is the contract, not
the implementation.
"""

from __future__ import annotations

import numpy as np

from .types import TimeSegment


def vote_grid(mvs: np.ndarray, gw: int, gh: int, *, threshold_sq: float,
              block_shift: int, y_min: int, y_max: int) -> np.ndarray:
    """Accumulate saturating uint8 votes from motion vectors.

    ``mvs`` is int array [N, 4] of (dst_x, dst_y, src_x, src_y) — the same
    integer fields the reference reads off AVMotionVector.  Matches
    motion_scanner.cpp:242-268 exactly:

    * magnitude is integer (dst-src)^2 sum, compared ``< threshold_sq``
      (double compare; keep when mag_sq >= threshold)
    * grid coords are arithmetic right shifts of dst (floor for negatives)
    * bounds: 0 <= gx < gw, y_min <= gy < y_max
    * votes saturate at 255
    """
    grid = np.zeros((gh, gw), dtype=np.uint8)
    for row in np.asarray(mvs, dtype=np.int64).reshape(-1, 4):
        dst_x, dst_y, src_x, src_y = (int(v) for v in row)
        dx = dst_x - src_x
        dy = dst_y - src_y
        # the reference accumulates `int mag_sq` (motion_scanner.cpp:248):
        # int16-extreme fields (|dx| up to 65535) overflow int32 and wrap
        # negative in C — and in the int32 device kernels — so the oracle
        # wraps identically (real codec MVs never get close; only
        # synthetic fuzz reaches this)
        mag_sq = ((dx * dx + dy * dy + (1 << 31)) % (1 << 32)) - (1 << 31)
        if mag_sq < threshold_sq:
            continue
        gx = dst_x >> block_shift
        gy = dst_y >> block_shift
        if 0 <= gx < gw and y_min <= gy < y_max:
            if grid[gy, gx] < 255:
                grid[gy, gx] += 1
    return grid


def count_clusters(grid: np.ndarray, *, vectors_needed: int, y_min: int,
                   y_max: int) -> int:
    """Count active cells having an active 4-neighbor.

    Matches motion_scanner.cpp:277-293 WITHOUT the early exit (the early
    exit only short-circuits the count; the motion decision is identical).
    Center cells scan y in [y_min, y_max), x in [1, gw-2].  Neighbor reads
    may touch rows y_min-1 / y_max; for the shipped configs (margin >= 1)
    those rows exist and are vote-free.  We define the margin==0 edge case
    (UB in the reference, motion_scanner.cpp:285-286) as reading zero votes.
    """
    gh, gw = grid.shape
    padded = np.zeros((gh + 2, gw), dtype=np.int32)
    padded[1:-1] = grid
    clusters = 0
    for y in range(y_min, y_max):
        for x in range(1, gw - 1):
            if padded[y + 1, x] >= vectors_needed:
                has_neighbor = (
                    padded[y + 1, x - 1] >= vectors_needed
                    or padded[y + 1, x + 1] >= vectors_needed
                    or padded[y, x] >= vectors_needed
                    or padded[y + 2, x] >= vectors_needed
                )
                if has_neighbor:
                    clusters += 1
    return clusters


def count_clusters_batch(grids: np.ndarray, *, vectors_needed: int,
                         y_min: int, y_max: int) -> np.ndarray:
    """Vectorized NumPy equivalent of count_clusters over [B, gh, gw].

    Same semantics as the naive loop (tested against it); exists so the
    'oracle' scan backend stays usable on long videos.
    """
    g = np.asarray(grids, dtype=np.int32)
    b, gh, gw = g.shape
    padded = np.zeros((b, gh + 2, gw + 2), dtype=np.int32)
    padded[:, 1:-1, 1:-1] = g
    center = padded[:, 1:-1, 1:-1]
    active = center >= vectors_needed
    neighbor = (
        (padded[:, 1:-1, :-2] >= vectors_needed)
        | (padded[:, 1:-1, 2:] >= vectors_needed)
        | (padded[:, :-2, 1:-1] >= vectors_needed)
        | (padded[:, 2:, 1:-1] >= vectors_needed)
    )
    mask = np.zeros((gh, gw), dtype=bool)
    mask[y_min:y_max, 1:max(1, gw - 1)] = True
    return np.sum(active & neighbor & mask, axis=(1, 2)).astype(np.int32)


def effective_clusters_needed(clusters_needed: int) -> int:
    """The reference triggers motion inside ``if (++clusters >= clust_need)``
    (motion_scanner.cpp:288-289): at least one cluster must exist even when
    CLUSTERS_NEEDED <= 0, and MV-less frames return false unconditionally
    (:219-221).  Count-then-compare kernels must therefore use
    max(1, clusters_needed)."""
    return max(1, clusters_needed)


def check_frame(mvs: np.ndarray, gw: int, gh: int, *, threshold_sq: float,
                block_shift: int, y_min: int, y_max: int,
                vectors_needed: int, clusters_needed: int) -> bool:
    """Full per-frame motion decision (motion_scanner.cpp:217-295).

    An empty MV list means the frame carried no side data (FFmpeg never
    attaches an empty one): the reference returns false before the vote
    or cluster phases run (`if (!sd) return false`, :219-221) — load-
    bearing at vectors_needed == 0, where zero-vote cells would
    otherwise count as active.
    """
    if len(np.asarray(mvs).reshape(-1, 4)) == 0:
        return False
    grid = vote_grid(mvs, gw, gh, threshold_sq=threshold_sq,
                     block_shift=block_shift, y_min=y_min, y_max=y_max)
    n = count_clusters(grid, vectors_needed=vectors_needed,
                       y_min=y_min, y_max=y_max)
    return n >= effective_clusters_needed(clusters_needed)


def merge_timestamps(timestamps) -> np.ndarray:
    """sort + unique (pipeline.cpp:302-304)."""
    ts = np.asarray(sorted(timestamps), dtype=np.float64)
    if ts.size == 0:
        return ts
    keep = np.ones(ts.size, dtype=bool)
    keep[1:] = ts[1:] != ts[:-1]
    return ts[keep]


def segments_from_timestamps(timestamps, *, max_gap_sec: float,
                             padding_sec: float,
                             duration: float) -> list[TimeSegment]:
    """Gap-split + pad + clamp (pipeline.cpp:325-354).

    Input timestamps must already be sorted+deduped (merge_timestamps).
    Splits where the gap between consecutive motion timestamps exceeds
    max_gap_sec (strict >), pads each run by padding_sec on both sides
    (clamped below at 0), then clamps end to duration and start to end.
    """
    ts = np.asarray(timestamps, dtype=np.float64)
    if ts.size == 0:
        return []
    raw: list[tuple[float, float]] = []
    curr_start = float(ts[0])
    last_act = float(ts[0])
    for t in ts[1:]:
        t = float(t)
        if t - last_act > max_gap_sec:
            raw.append((max(0.0, curr_start - padding_sec),
                        last_act + padding_sec))
            curr_start = t
        last_act = t
    raw.append((max(0.0, curr_start - padding_sec), last_act + padding_sec))

    segments = []
    for start, end in raw:
        end = min(end, duration)
        start = min(start, end)
        segments.append(TimeSegment(start, end))
    return segments


def savings(segments: list[TimeSegment], duration: float) -> tuple[float, float]:
    """(time_removed, saved_pct) — pipeline.cpp:349-356."""
    out_dur = sum(s.end - s.start for s in segments)
    time_removed = duration - out_dur
    saved_pct = time_removed / duration * 100.0 if duration > 0 else 0.0
    return time_removed, saved_pct


def decide_cut(segments: list[TimeSegment], duration: float,
               min_savings_pct: float) -> tuple[bool, list[TimeSegment]]:
    """Cut-vs-copy decision (pipeline.cpp:358-404).

    Returns (is_cut, segments_to_emit).  On low savings (strict >
    comparison fails) the emitted list is a single full-duration segment.
    """
    _, saved_pct = savings(segments, duration)
    if saved_pct > min_savings_pct:
        return True, segments
    return False, [TimeSegment(0.0, duration)]


def format_cut_point(t: float) -> str:
    """inpoint/outpoint text formatting (pipeline.cpp:468-469).

    fmt's ``{:.2f}`` matches C printf ``%.2f`` (round-half-to-even on the
    binary value), which Python's format() also implements.
    """
    return f"{t:.2f}"


def concat_list(abs_path: str, segments: list[TimeSegment]) -> str:
    """The ffmpeg concat-demuxer list text (pipeline.cpp:459-470).

    Zero-length (end <= start) segments are dropped.
    """
    lines = []
    for s in segments:
        if s.end <= s.start:
            continue
        lines.append(f"file '{abs_path}'\n")
        lines.append(f"inpoint {format_cut_point(s.start)}\n")
        lines.append(f"outpoint {format_cut_point(s.end)}\n")
    return "".join(lines)
