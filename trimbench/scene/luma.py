"""Decoded luma planes, as the native scan (``scan_luma``) hands them over:
uint8 ``[N, height, width]``.

The pool, on the pattern of a CCTV camera that records a still scene: a
textured background (``background`` grey levels, uniform), ``noise``
grey levels of sensor noise a pixel on ``noise_planes`` planes (frame i
of a file takes plane ``i % noise_planes``, so two consecutive frames
never share one); then, for each of ``objects``, ``track_frames`` frames
of it moving across the scene: an ``h`` x ``w`` texture of its own,
grey levels uniform in ``texture``, ``speed_px`` pixels a frame to the
right.  A texture of narrow range (dark clothes at night) puts its
blocks' SAD near the bound, so that frame decisions hang on every
pixel.
"""

from __future__ import annotations

import numpy as np

from ..reference import rule


class Scene:
    side_data = False

    def __init__(self, camera: dict, params: dict, geom: rule.Geometry,
                 seed: int):
        h_px, w_px = int(camera["height"]), int(camera["width"])
        rng = np.random.default_rng([seed, 2])
        self.planes = int(params["noise_planes"])
        self.track_frames = int(params["track_frames"])
        objects = params["objects"]
        self.tracks = len(objects)
        lo, hi = params["background"]
        background = rng.integers(lo, hi + 1, (h_px, w_px), np.int16)
        n = int(params["noise"])
        noise = rng.integers(-n, n + 1, (self.planes, h_px, w_px), np.int16)
        self.pool = np.empty((self.planes + self.tracks * self.track_frames,
                              h_px, w_px), np.uint8)
        frame = np.empty((h_px, w_px), np.int16)
        for k in range(self.planes):
            np.add(background, noise[k], out=frame)
            np.clip(frame, 0, 255, out=frame)
            self.pool[k] = frame
        for t, obj in enumerate(objects):
            h, w, speed = int(obj["h"]), int(obj["w"]), int(obj["speed_px"])
            travel = speed * (self.track_frames - 1)
            y0 = int(rng.integers(0, h_px - h + 1))
            x0 = int(rng.integers(0, w_px - w - travel + 1))
            tlo, thi = obj["texture"]
            texture = rng.integers(tlo, thi + 1, (h, w), np.int16)
            for j in range(self.track_frames):
                np.add(background, noise[j % self.planes], out=frame)
                x = x0 + speed * j
                frame[y0:y0 + h, x:x + w] = texture
                np.clip(frame, 0, 255, out=frame)
                self.pool[self.planes + t * self.track_frames + j] = frame

    def check(self, args: dict) -> None:
        if args:
            raise RuntimeError(f"scan_luma takes no {sorted(args)}")

    def index(self, spec, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        i = np.arange(lo, hi)
        idx = i % self.planes
        win, off = spec.window_of(lo, hi)
        inside = win >= 0
        if inside.any():
            picks = np.array([p for _, _, p in spec.windows], np.int64)
            track = picks[win[inside]] % self.tracks
            idx[inside] = (self.planes + track * self.track_frames
                           + off[inside] % self.track_frames)
        return idx, np.zeros(hi - lo, bool)

    def serve(self, idx: np.ndarray) -> np.ndarray:
        return np.take(self.pool, idx, axis=0)
