"""Packed activity masks, as the native MV scan (``scan_bits``) hands them
over: uint8 ``[N, gh, ceil(gw / 8)]``, a set bit a cell whose votes
reached ``VECTORS_NEEDED``.

The pool: entry 0 is the empty mask of a frame without MV side data (an
I-frame, or every frame of an intra-only camera); then ``static_pool``
masks of a static scene, a few isolated cells on an even lattice (so
never a cluster); then ``tracks`` objects of ``track_frames`` masks each,
a blob of ``blob_cells`` cells (log-uniform), ``blob_fill`` of them set,
moving a cell every ``step_frames`` frames, with every ``weak_every``-th
frame of a track reduced to two isolated cells (a frame inside a motion
window whose MVs fall short, as recorded encoder output shows).
Cells outside the rows ``[y_min, y_max)`` are never set: the scan drops
those MVs.
"""

from __future__ import annotations

import numpy as np

from ..reference import rule


class Scene:
    def __init__(self, camera: dict, params: dict, geom: rule.Geometry,
                 seed: int):
        self.geom = geom
        self.side_data = bool(camera["mv_side_data"])
        self.gop = int(camera.get("gop", 0))
        rng = np.random.default_rng([seed, 1])
        if not self.side_data:
            self.static_n = self.tracks = self.track_frames = 0
            self.pool = np.zeros((1, geom.gh, geom.mask_bytes), np.uint8)
            return
        self.static_n = int(params["static_pool"])
        self.tracks = int(params["tracks"])
        self.track_frames = int(params["track_frames"])
        active = np.zeros((1 + self.static_n + self.tracks
                           * self.track_frames, geom.gh, geom.gw), bool)
        rows = np.arange(geom.y_min, geom.y_max)
        lattice_y = rows[rows % 2 == 0]
        lattice_x = np.arange(0, geom.gw, 2)
        for k in range(self.static_n):
            for _ in range(rng.poisson(params["static_cells"])):
                active[1 + k, rng.choice(lattice_y), rng.choice(lattice_x)] = True
        lo, hi = np.log(params["blob_cells"])
        base = 1 + self.static_n
        for t in range(self.tracks):
            area = float(np.exp(rng.uniform(lo, hi)))
            aspect = rng.uniform(*params["blob_aspect"])
            h = int(np.clip(round(np.sqrt(area * aspect)), 2,
                            geom.y_max - geom.y_min))
            w = int(np.clip(round(area / h), 2, geom.gw - 4))
            y0 = int(rng.integers(geom.y_min, geom.y_max - h + 1))
            x0 = int(rng.integers(1, geom.gw - 1 - w))
            span = geom.gw - 2 - w
            for j in range(self.track_frames):
                frame = active[base + t * self.track_frames + j]
                if j % params["weak_every"] == params["weak_every"] // 2:
                    for _ in range(2):
                        frame[rng.choice(lattice_y), rng.choice(lattice_x)] = True
                    continue
                x = 1 + (x0 - 1 + j // params["step_frames"]) % span
                frame[y0:y0 + h, x:x + w] = rng.random((h, w)) < params[
                    "blob_fill"]
        self.pool = rule.pack_masks(active)

    def check(self, args: dict) -> None:
        """The scan's grid has to be the camera's."""
        g = self.geom
        asked = tuple(args.get(k) for k in ("gw", "gh", "y_min", "y_max"))
        if asked != (g.gw, g.gh, g.y_min, g.y_max):
            raise RuntimeError(f"scan_bits asked for grid {asked}, the "
                               f"camera's is {(g.gw, g.gh, g.y_min, g.y_max)}")

    def index(self, spec, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """Pool indices of frames lo..hi-1 and whether each carries MV
        side data."""
        if not self.side_data:
            return np.zeros(hi - lo, np.int64), np.zeros(hi - lo, bool)
        i = np.arange(lo, hi)
        idx = 1 + i % self.static_n
        win, off = spec.window_of(lo, hi)
        inside = win >= 0
        if inside.any():
            picks = np.array([p for _, _, p in spec.windows], np.int64)
            track = picks[win[inside]] % self.tracks
            idx[inside] = (1 + self.static_n + track * self.track_frames
                           + off[inside] % self.track_frames)
        side = (i % self.gop != 0) if self.gop else np.ones(hi - lo, bool)
        idx[~side] = 0
        return idx, side

    def serve(self, idx: np.ndarray) -> np.ndarray:
        return np.take(self.pool, idx, axis=0)
