"""The benchmark's stand-ins for what the card's machine lacks: the
decoder (libav) and the remux (ffmpeg).

``Decoder`` takes the place of ``mvtrim_tpu_torch.io.native.VideoReader``
(``install`` sets it there, so the probe and every decode worker open
it).  It knows every file of the backlog by path and serves a file's
frames as the native scan does: the frames whose pts lie in
``[start, end)``, at most ``max_frames`` of them, and with ``resume`` the
frames after the last one it served; a ``timing`` counts the frames that
carry MV side data.  ``scan_<payload>`` serves the scene module of that
name (``scene/<payload>.py``); each call hands over a fresh array, one
copy a frame out of the scene's pool.

``Remux`` takes the place of the external ffmpeg of the cut: with
``MVT_FFMPEG_BIN`` set the program's cut worker builds the concat list
and hands it to ``executor._external_cut``, which would write it to a
memfd and run ffmpeg on it; the stand-in keeps the list, by output file
name, and runs nothing (a process a cut, even a shell's, cost the cut
worker about 10 ms, more than the window's files take to scan).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np

# the program's external-cut path is taken when MVT_FFMPEG_BIN is set;
# nothing runs this name
FFMPEG_BIN = "trimbench-remux-standin"


class Decoder:
    """Opens stand-in readers over the backlog's files."""

    def __init__(self, camera: dict, scenes: dict, specs, recorder=None):
        self.camera = camera
        self.scenes = scenes
        self.specs = {s.name: s for s in specs}
        self.recorder = recorder

    def __call__(self, path: str, mode: int = 0) -> "Reader":
        spec = self.specs.get(path)
        if spec is None:
            raise OSError(f"mvt_open({path}): no such recording")
        return Reader(self, spec)


class Reader:
    def __init__(self, decoder: Decoder, spec):
        t0 = time.time_ns()
        self.decoder = decoder
        self.spec = spec
        self.path = spec.name
        self.duration = spec.duration
        self.fps = spec.fps
        self.width = int(decoder.camera["width"])
        self.height = int(decoder.camera["height"])
        self.next = 0
        self._span("standin_open", t0, 0)

    def _span(self, kind: str, t0: int, value: int) -> None:
        rec = self.decoder.recorder
        if rec is not None and rec.tracing:
            rec.span(kind, t0, time.time_ns(), value)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _range(self, start: float, end: float, frame_skip: int,
               max_frames: int, resume: bool) -> tuple[int, int, np.ndarray]:
        if frame_skip != 1:
            raise RuntimeError(f"frame_skip {frame_skip} is not served")
        pts = np.arange(self.spec.frames) / self.spec.fps
        lo = self.next if resume else int(np.searchsorted(pts, start))
        hi = max(lo, min(lo + max_frames, int(np.searchsorted(pts, end))))
        self.next = hi
        return lo, hi, pts[lo:hi]

    def __getattr__(self, name: str):
        """``scan_<payload>`` for each payload the camera records."""
        payload = name[len("scan_"):] if name.startswith("scan_") else ""
        if payload not in self.decoder.scenes:
            raise AttributeError(name)
        return functools.partial(self._scan, payload)

    def _scan(self, payload: str, start: float, end: float, *,
              frame_skip: int = 1, max_frames: int = 4096, timing=None,
              resume: bool = False, **args):
        t0 = time.time_ns()
        scene = self.decoder.scenes[payload]
        scene.check(args)
        lo, hi, pts = self._range(start, end, frame_skip, max_frames, resume)
        idx, side = scene.index(self.spec, lo, hi)
        data = scene.serve(idx)
        if timing is not None:
            timing.frames_with_mvs += int(side.sum())
        self._span("standin_scan", t0, hi - lo)
        # a scene hands over one array, or a tuple (fields and counts)
        return (*data, pts) if isinstance(data, tuple) else (data, pts)


class Remux:
    """Keeps each concat list the cut worker hands over, by the output
    file's name."""

    def __init__(self):
        self.lists: dict[str, str] = {}

    def __call__(self, ffmpeg_bin: str, output_path: str, list_text: str,
                 cpus=None) -> None:
        self.lists[os.path.basename(output_path)] = list_text


def install(decoder: Decoder, remux: Remux):
    """Put the stand-ins at the program's seams; returns the undo."""
    from mvtrim_tpu_torch.cut import executor
    from mvtrim_tpu_torch.io import native

    real = native.VideoReader, executor._external_cut
    native.VideoReader, executor._external_cut = decoder, remux

    def undo() -> None:
        native.VideoReader, executor._external_cut = real

    return undo
