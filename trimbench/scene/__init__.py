"""What a camera records, as pools of frames built once a run.

A file of the backlog is a timeline (``FileSpec``): its frame count, its
frame rate and its motion windows.  A scene module turns a stretch of a
timeline into pool indices, and serves those frames as fresh arrays, one
copy a frame, as a decoder hands over what it decoded.  A configuration
names its payloads (``scene`` in its file); each is the module of that
name here, built by ``build(name, camera, params, geom, seed)``.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class FileSpec:
    """One recording: ``frames`` at ``fps``; ``windows`` are (first frame,
    end frame, pick): the frames of ``[first, end)`` show an object, and
    ``pick`` chooses which of the scene's objects."""

    name: str
    frames: int
    fps: float
    windows: tuple[tuple[int, int, int], ...]

    @property
    def duration(self) -> float:
        return self.frames / self.fps

    def motion_frames(self) -> int:
        return sum(b - a for a, b, _ in self.windows)

    def window_of(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """For frames lo..hi-1: the window each lies in (-1 for none) and
        its offset from that window's first frame."""
        i = np.arange(lo, hi)
        win = np.full(hi - lo, -1, np.int64)
        off = np.zeros(hi - lo, np.int64)
        for w, (a, b, _) in enumerate(self.windows):
            inside = (i >= a) & (i < b)
            win[inside] = w
            off[inside] = i[inside] - a
        return win, off


def build(payload: str, camera: dict, params: dict, geom, seed: int):
    module = importlib.import_module(f"{__name__}.{payload}")
    return module.Scene(camera, params, geom, seed)
