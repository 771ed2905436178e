"""The device side of a traced window, from ``torch.profiler``.

``Profiler`` traces the card (CUDA activity only: the host side is the
benchmark's own spans, which cost far less than recording every host
operation of three streams).  ``from_chrome`` keeps the operations that
ran on the card, on the host's ``time.time_ns`` clock, which the
profiler's timestamps follow.  The functions below reduce them: the union of busy
time, the idle gaps, the time and bytes by kind and by name.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    kind: str      # kernel, memcpy_htod, memcpy_dtoh, memcpy, memset
    nbytes: int


def kind_of(name: str) -> str:
    if name.startswith("Memcpy"):
        if "HtoD" in name:
            return "memcpy_htod"
        if "DtoH" in name:
            return "memcpy_dtoh"
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


KINDS = {"kernel": "kernel", "gpu_memset": "memset"}


class Profiler:
    """Traces the card over the window and returns its operations,
    read from the profiler's exported trace: only the export carries a
    copy's bytes."""

    def __init__(self, path: str):
        from torch.profiler import ProfilerActivity, profile

        self.path = path
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> list[DeviceOp]:
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                return from_chrome(json.load(f))
        finally:
            os.remove(self.path)


def from_chrome(doc: dict) -> list[DeviceOp]:
    """The card's operations of an exported trace, on the host's
    ``time.time_ns`` clock (``baseTimeNanoseconds`` plus ``ts`` in µs)."""
    base = int(doc.get("baseTimeNanoseconds", 0))
    ops = []
    for ev in doc["traceEvents"]:
        cat = ev.get("cat")
        if ev.get("ph") != "X" or (cat not in KINDS and cat != "gpu_memcpy"):
            continue
        start = base + int(round(float(ev["ts"]) * 1e3))
        end = start + int(round(float(ev.get("dur", 0)) * 1e3))
        name = ev.get("name", "")
        kind = kind_of(name) if cat == "gpu_memcpy" else KINDS[cat]
        ops.append(DeviceOp(name, start, end, kind,
                            int(ev.get("args", {}).get("bytes", 0))))
    return ops


def clipped(ops: list[DeviceOp], t0: int, t1: int) -> list[DeviceOp]:
    return [dataclasses.replace(op, start_ns=max(op.start_ns, t0),
                                end_ns=min(op.end_ns, t1))
            for op in ops if op.end_ns > t0 and op.start_ns < t1]


def busy_intervals(ops: list[DeviceOp]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted((op.start_ns, op.end_ns) for op in ops):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_ns(ops: list[DeviceOp]) -> int:
    return sum(b - a for a, b in busy_intervals(ops))


def idle_gaps(ops: list[DeviceOp], t0: int, t1: int) -> list[tuple[int, int]]:
    gaps, last = [], t0
    for a, b in busy_intervals(ops):
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t1 > last:
        gaps.append((last, t1))
    return gaps


def by_name(ops: list[DeviceOp]) -> dict[str, float]:
    """Seconds on the card by operation name."""
    out: dict[str, float] = {}
    for op in ops:
        out[op.name] = out.get(op.name, 0.0) + (op.end_ns - op.start_ns) / 1e9
    return out


def label_gaps(gaps, spans, count: int = 10) -> list[list]:
    """The ``count`` longest gaps, each named by the host span kind that
    overlaps it most (summed over the threads), with its seconds."""
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:count]
    if spans:
        kinds = np.array([s[0] for s in spans])
        starts = np.array([s[1] for s in spans], np.int64)
        ends = np.array([s[2] for s in spans], np.int64)
    out = []
    for a, b in longest:
        label = "no benchmark span"
        if spans:
            overlap = np.clip(np.minimum(ends, b) - np.maximum(starts, a),
                              0, None)
            if overlap.max() > 0:
                totals = {k: int(overlap[kinds == k].sum())
                          for k in set(kinds[overlap > 0].tolist())}
                label = max(totals, key=totals.get)
        out.append([label, (b - a) / 1e9])
    return out
