"""How ``correct`` is decided: every file whose ``run()`` ended is held to
the plain reference, worked out again from the frames the stand-in
served.

Per file, the reference gives the scans the configured pipeline makes
(``MVT_PIPELINE``: ``mv`` scans the MV payload; ``auto`` then falls back
to the pixel-domain scan when the MV scan found no motion and no frame
carried MV side data; ``sad`` scans pixels only), each with its frames,
its frames with MV side data and its motion timestamps, and the cut:
no cut job without motion, else the concat list of the cut or of the
whole-file copy.  The numbers compared, each with its limit:

- ``files_checked``: files whose ``run()`` ended, at least 1;
- ``files_failed``: runs that returned nonzero or raised, 0;
- ``files_wrong_frames``: scans, frames or frames with MVs differing, 0;
- ``files_wrong_motion``: motion timestamps differing in any scan, 0;
- ``files_wrong_cut``: concat list (or its absence) differing, 0.
"""

from __future__ import annotations

import dataclasses
import importlib
import os

import numpy as np

from .reference import frames as ref_frames
from .reference import segments as ref_segments

# MVT_SCAN_INPUT -> the scan the stand-in serves (``scan_<payload>``)
PAYLOADS = {"bits": "bits", "words": "words", "grids": "grids",
            "mv_raw": "mvs"}
LIMITS = {"files_checked": ("min", 1), "files_failed": ("max", 0),
          "files_wrong_frames": ("max", 0), "files_wrong_motion": ("max", 0),
          "files_wrong_cut": ("max", 0)}


@dataclasses.dataclass
class Expected:
    passes: list          # (kind, frames, frames with MVs, motion ts)
    decision: str
    concat: str | None


class Reference:
    """The reference's answers for files of one configuration.  A scan
    reads the payload the knobs name (``MVT_SCAN_INPUT`` for the MV scan,
    luma for the pixel scan); ``reference/<payload>.py`` decides it."""

    def __init__(self, knobs: dict, scenes: dict, geom):
        self.knobs = knobs
        self.scenes = scenes
        self.geom = geom
        self.chunk_s = float(knobs["CHUNK_DURATION_SEC"])
        self.mode = knobs.get("MVT_PIPELINE", "auto")
        self.payloads = {"mv": PAYLOADS[knobs.get("MVT_SCAN_INPUT", "bits")],
                         "sad": "luma"}
        self._deciders = {}

    def decider(self, payload: str):
        if payload not in self._deciders:
            module = importlib.import_module(
                f"{ref_frames.__package__}.{payload}")
            self._deciders[payload] = module.Decider(
                self.scenes[payload].pool, self.geom, self.knobs)
        return self._deciders[payload]

    def motion(self, kind: str, spec) -> tuple[np.ndarray, int]:
        """bool [frames] of one scan, and its frames with MV side data."""
        payload = self.payloads[kind]
        idx, side = self.scenes[payload].index(spec, 0, spec.frames)
        firsts = ref_frames.chunk_firsts(spec.frames, spec.fps, self.chunk_s)
        return self.decider(payload)(idx, firsts), int(side.sum())

    def expected(self, spec, motion=None) -> Expected:
        """``motion(kind, spec)`` may stand in for the reference's own
        per-frame decisions (the control does so)."""
        motion = motion or self.motion
        pts = ref_frames.pts_of(spec.frames, spec.fps)
        passes = []
        kinds = ["sad"] if self.mode == "sad" else ["mv"]
        for kind in kinds:
            moving, with_mvs = motion(kind, spec)
            passes.append((kind, spec.frames, with_mvs, pts[moving]))
            if (kind == "mv" and self.mode == "auto" and not moving.any()
                    and spec.frames > 0 and with_mvs == 0):
                kinds.append("sad")
        decision, concat = ref_segments.cut_of(
            passes[-1][3], spec.duration, os.path.abspath(spec.name),
            self.knobs)
        return Expected(passes, decision, concat)


def _same_passes(got: list, want: list) -> tuple[bool, bool]:
    """(frames agree, motion agrees)."""
    frames = [p[:3] for p in got] == [p[:3] for p in want]
    motion = len(got) == len(want) and all(
        np.array_equal(np.unique(g[3]), w[3]) for g, w in zip(got, want))
    return frames, motion


def compare(records, specs: dict, lists: dict, reference: Reference):
    """records: the program's FileRecords; specs: path -> FileSpec;
    lists: path -> the concat list the cut handed over (absent: none).
    Returns (numbers, the first few faults as text)."""
    numbers = dict.fromkeys(LIMITS, 0)
    faults = []
    for rec in records:
        numbers["files_checked"] += 1
        spec = specs[rec.path]
        want = reference.expected(spec)
        if rec.rc != 0 or rec.error:
            numbers["files_failed"] += 1
            faults.append(f"{rec.path}: rc {rec.rc} {rec.error}")
            continue
        frames_ok, motion_ok = _same_passes(rec.passes, want.passes)
        if not frames_ok:
            numbers["files_wrong_frames"] += 1
            faults.append(f"{rec.path}: scans {[p[:3] for p in rec.passes]}"
                          f", reference {[p[:3] for p in want.passes]}")
        if not motion_ok:
            numbers["files_wrong_motion"] += 1
            faults.append(f"{rec.path}: motion frames "
                          f"{[len(np.unique(p[3])) for p in rec.passes]}, "
                          f"reference {[len(p[3]) for p in want.passes]}")
        if lists.get(rec.path) != want.concat:
            numbers["files_wrong_cut"] += 1
            faults.append(f"{rec.path}: list {lists.get(rec.path)!r}, "
                          f"reference {want.decision} {want.concat!r}")
    return numbers, faults[:5]


def passes(numbers: dict) -> bool:
    for name, (side, limit) in LIMITS.items():
        value = numbers[name]
        if (side == "min" and value < limit) or (side == "max"
                                                 and value > limit):
            return False
    return True
