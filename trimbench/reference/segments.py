"""From motion timestamps to the cut, written out plainly
(pipeline.cpp:302-470).

Timestamps are sorted and made unique; a run of motion splits where the
gap to the next motion timestamp exceeds ``MAX_GAP_SEC``; each run is
padded by ``PADDING_SEC`` on both sides (not below 0) and its end clamped
to the duration.  The file is cut when the share removed exceeds
``MIN_SAVINGS_PCT``, and copied whole otherwise.  The concat list names
the input once a kept segment, with in- and outpoints as ``%.2f``, and
drops segments whose end is not after their start.  A file with no
motion gets no cut job at all.
"""

from __future__ import annotations

import numpy as np


def merge(timestamps) -> np.ndarray:
    return np.unique(np.asarray(timestamps, np.float64))


def segments(ts: np.ndarray, duration: float,
             knobs: dict) -> list[tuple[float, float]]:
    gap = float(knobs["MAX_GAP_SEC"])
    pad = float(knobs["PADDING_SEC"])
    runs = []
    first = last = float(ts[0])
    for t in ts[1:]:
        t = float(t)
        if t - last > gap:
            runs.append((first, last))
            first = t
        last = t
    runs.append((first, last))
    out = []
    for a, b in runs:
        end = min(b + pad, duration)
        out.append((min(max(0.0, a - pad), end), end))
    return out


def decide(segs: list[tuple[float, float]], duration: float,
           knobs: dict) -> tuple[str, list[tuple[float, float]]]:
    kept = sum(b - a for a, b in segs)
    saved_pct = (duration - kept) / duration * 100.0 if duration > 0 else 0.0
    if saved_pct > float(knobs["MIN_SAVINGS_PCT"]):
        return "cut", segs
    return "copy", [(0.0, duration)]


def concat_list(abs_path: str, segs: list[tuple[float, float]]) -> str:
    lines = []
    for a, b in segs:
        if b <= a:
            continue
        lines.append(f"file '{abs_path}'\ninpoint {a:.2f}\n"
                     f"outpoint {b:.2f}\n")
    return "".join(lines)


def cut_of(ts, duration: float, abs_path: str,
           knobs: dict) -> tuple[str, str | None]:
    """(decision, concat list or None) of a file's motion timestamps:
    ``no_motion`` with no list, else ``cut`` or ``copy`` with its list."""
    ts = merge(ts)
    if ts.size == 0:
        return "no_motion", None
    decision, segs = decide(segments(ts, duration, knobs), duration, knobs)
    return decision, concat_list(abs_path, segs)
