"""Raw motion vectors, as the native MV scan (``scan_mvs``) hands them
over: int16 ``[N, max_mv, 4]`` fields (dst_x, dst_y, src_x, src_y), zeros
past each frame's count, and int32 ``[N]`` counts.  A frame with more MVs
than ``max_mv`` keeps its first ``max_mv`` and its count is minus the real
one.  Each call hands over a fresh array, as the native reader allocates
one.

``check(args)`` takes the scan's ``max_mv``, the one argument it knows,
and keeps it for the ``serve`` that follows on the same thread: the
stand-in calls the two in turn, and decode workers ask for different
capacities at once.

The pool is ``(fields int16 [E, W, 4], counts int32 [E])``, zeros past
each count, W the power of two that holds the largest count: a call at a
capacity up to W is one gather (one native call, as a decoder's is).
Entry 0 is a frame without MV side data (an I-frame, count 0);
then ``static_pool`` static frames, ``noisy_share`` of them noisy and the
rest quiet; then ``tracks`` objects of ``track_frames`` motion frames
each.  A frame's count is drawn by the quartiles of its class
(``counts``, at ``macroblocks`` macroblocks, scaled by the camera's).  A
cell of the grid stands for a macroblock: each holds one MV where the
count allows, the rest are further partitions of random macroblocks, and
a frame lists them in macroblock raster order, as a decoder exports them,
each at the centre of a partition.

Votes (MVs at or over ``threshold_sq``, the ``MV_THRESHOLD_SQ`` the scene
is calibrated at): background MVs stay under it.  In a static frame
``noise_over_share`` of the MVs pass it, one to a macroblock, so they vote
alone, and ``isolated_cells`` cells on an even lattice get two, so they
are active and never touch.  A motion frame has the noisy class's noise
and a blob of ``blob_cells`` cells moving a cell every ``step_frames``
frames, ``blob_fill`` of them with ``blob_mvs`` large MVs.
``edge_share`` of static frames carry the keep rule's edges: in two rows,
an active cell in column 1 beside MVs with a negative ``dst_x`` (column
-1 by an arithmetic shift, 0 by a truncating one); and where the grid
masks rows, two active cells in row ``y_min`` with votes in the masked
row above them.  Either, mishandled, reads as two clusters.
"""

from __future__ import annotations

import threading

import numpy as np

from ..reference import rule

# the native scan's default capacity, where a caller names none
DEFAULT_MAX_MV = 8192
QUARTILES = (0.0, 0.25, 0.5, 0.75, 1.0)


def _pairs(lo: int, hi: int, radius: int) -> np.ndarray:
    """Integer (dx, dy) with lo <= dx² + dy² < hi and |dx|, |dy| <= radius."""
    d = np.arange(-radius, radius + 1)
    dx, dy = (a.ravel() for a in np.meshgrid(d, d))
    mag = dx * dx + dy * dy
    keep = (mag >= lo) & (mag < hi)
    return np.stack([dx[keep], dy[keep]], axis=1)


class Scene:
    def __init__(self, camera: dict, params: dict, geom: rule.Geometry,
                 seed: int):
        self.geom = geom
        self.side_data = bool(camera["mv_side_data"])
        self.gop = int(camera.get("gop", 0))
        self._asked = threading.local()
        if not self.side_data:
            self.static_n = self.tracks = self.track_frames = 0
            self.pool = (np.zeros((1, 0, 4), np.int16),
                         np.zeros(1, np.int32))
            return
        rng = np.random.default_rng([seed % 2 ** 64, 3])
        self.params = params
        self.static_n = int(params["static_pool"])
        self.tracks = int(params["tracks"])
        self.track_frames = int(params["track_frames"])
        self.scale = geom.gw * geom.gh / float(params["macroblocks"])
        t = int(np.ceil(float(params["threshold_sq"])))
        self.small = _pairs(0, t, int(np.sqrt(t)))
        self.noise = _pairs(t, 4 * t + 1, 2 * int(np.sqrt(t)) + 1)

        frames = [np.zeros((0, 4), np.int16)]
        noisy = int(round(params["noisy_share"] * self.static_n))
        for noisy_frame in rng.permutation(self.static_n) < noisy:
            frames.append(self._static(rng, "noisy" if noisy_frame
                                       else "quiet"))
        lo, hi = np.log(params["blob_cells"])
        for _ in range(self.tracks):
            area = float(np.exp(rng.uniform(lo, hi)))
            aspect = rng.uniform(*params["blob_aspect"])
            h = int(np.clip(round(np.sqrt(area * aspect)), 2,
                            geom.y_max - geom.y_min))
            w = int(np.clip(round(area / h), 2, geom.gw - 4))
            y0 = int(rng.integers(geom.y_min, geom.y_max - h + 1))
            x0 = int(rng.integers(1, geom.gw - 1 - w))
            span = geom.gw - 2 - w
            for j in range(self.track_frames):
                x = 1 + (x0 - 1 + j // params["step_frames"]) % span
                frames.append(self._moving(rng, y0, x, h, w))
        counts = np.array([len(f) for f in frames], np.int32)
        width = 1 << int(np.ceil(np.log2(max(1, counts.max()))))
        fields = np.zeros((len(frames), width, 4), np.int16)
        for e, f in enumerate(frames):
            fields[e, :len(f)] = f
        self.pool = (fields, counts)

    # --- building a frame ---

    def _count(self, rng, kind: str) -> int:
        q = self.params["counts"][kind]
        return int(round(np.interp(rng.random(), QUARTILES, q) * self.scale))

    def _lattice(self, rng, kind: str, forbidden: np.ndarray) -> np.ndarray:
        """Cells (flat) of the isolated active cells: even row, even
        column, none forbidden."""
        g = self.geom
        lattice = np.zeros((g.gh, g.gw), bool)
        lattice[0::2, 0::2] = True
        free = np.flatnonzero(lattice & ~forbidden)
        lo, hi = self.params["isolated_cells"][kind]
        k = min(len(free), int(round(rng.uniform(lo, hi) * self.scale)))
        return rng.choice(free, size=k, replace=False)

    def _static(self, rng, kind: str) -> np.ndarray:
        g = self.geom
        n = self._count(rng, kind)
        votes = {}      # flat cell -> MVs over the threshold it holds
        negative = []   # flat cells whose MVs over it get a negative dst_x
        forbidden = np.zeros((g.gh, g.gw), bool)
        if rng.random() < self.params["edge_share"] and g.gw >= 8 \
                and g.y_max - g.y_min >= 6:
            rows = rng.choice(np.arange(g.y_min + 2, g.y_max, 2), size=2,
                              replace=False)
            for gy in rows:
                votes[gy * g.gw + 1] = 2
                votes[gy * g.gw] = 2
                negative.append(gy * g.gw)
                forbidden[gy - 1:gy + 2, 0:3] = True
            if g.y_min >= 1:
                for gx in rng.choice(np.arange(3, g.gw - 1, 3), size=2,
                                     replace=False):
                    votes[g.y_min * g.gw + gx] = 2
                    votes[(g.y_min - 1) * g.gw + gx] = 2
                    forbidden[g.y_min - 1:g.y_min + 2, gx - 1:gx + 2] = True
        for cell in self._lattice(rng, kind, forbidden):
            votes[int(cell)] = 2
        return self._frame(rng, n, kind, votes, {}, negative)

    def _moving(self, rng, y0: int, x0: int, h: int, w: int) -> np.ndarray:
        g = self.geom
        n = self._count(rng, "motion")
        blob = {}
        lo, hi = self.params["blob_mvs"]
        fill = rng.random((h, w)) < self.params["blob_fill"]
        for dy, dx in zip(*np.nonzero(fill)):
            blob[(y0 + dy) * g.gw + x0 + dx] = int(rng.integers(lo, hi + 1))
        forbidden = np.zeros((g.gh, g.gw), bool)
        forbidden[y0:y0 + h, x0:x0 + w] = True
        votes = {int(c): 2 for c in self._lattice(rng, "noisy", forbidden)}
        return self._frame(rng, n, "noisy", votes, blob, [])

    def _frame(self, rng, n: int, kind: str, votes: dict, blob: dict,
               negative: list) -> np.ndarray:
        """The MVs of one frame: about ``n``, at least one a macroblock
        where ``n`` allows, ``votes`` noise MVs and ``blob`` large MVs in
        the cells named, and noise MVs alone in ``noise_over_share`` of
        them elsewhere; int16 [count, 4] in raster order."""
        g = self.geom
        cells = g.gw * g.gh
        held = np.zeros(cells, np.int64)
        if n >= cells:
            held[:] = 1
        else:
            held[rng.choice(cells, size=n, replace=False)] = 1
        need = dict(votes)
        for c, k in blob.items():
            need[c] = need.get(c, 0) + k
        lo, hi = self.params["noise_over_share"][kind]
        taken = np.zeros(cells, bool)
        taken[list(need)] = True
        free = np.flatnonzero(~taken)
        alone = rng.choice(free, size=min(len(free), int(round(
            rng.uniform(lo, hi) * n))), replace=False)
        for c in alone:
            need[int(c)] = 1
        want = np.zeros(cells, np.int64)
        want[list(need)] = list(need.values())
        held = np.maximum(held, want)
        extra = n - int(held.sum())
        if extra > 0:
            held += np.bincount(rng.integers(0, cells, extra), minlength=cells)

        first = np.concatenate([[0], np.cumsum(held)[:-1]])
        mb = np.repeat(np.arange(cells), held)
        total = len(mb)
        quarter = g.block // 4
        part = rng.integers(1, 4, size=(total, 2)) * quarter
        dst = np.stack([mb % g.gw * g.block + part[:, 0],
                        mb // g.gw * g.block + part[:, 1]], axis=1)
        vec = self.small[rng.integers(0, len(self.small), total)]
        vec[rng.random(total) < 0.6] = 0
        cell = np.fromiter(need, np.int64, len(need))
        k = np.fromiter(need.values(), np.int64, len(need))
        rows = (np.repeat(first[cell], k) + np.arange(k.sum())
                - np.repeat(np.cumsum(k) - k, k))
        large = np.repeat(np.isin(cell, list(blob)), k)
        vec[rows[~large]] = self.noise[rng.integers(
            0, len(self.noise), int((~large).sum()))]
        m = int(large.sum())
        vec[rows[large]] = np.stack([rng.integers(5, 41, m)
                                     * rng.choice([-1, 1], m),
                                     rng.integers(-8, 9, m)], axis=1)
        below = rows[np.repeat(np.isin(cell, negative), k)]
        dst[below, 0] = -rng.integers(1, g.block, len(below))
        out = np.empty((total, 4), np.int16)
        out[:, :2] = dst
        out[:, 2:] = dst - vec
        return out

    # --- the stand-in's calls ---

    def check(self, args: dict) -> None:
        """The scan's arguments: ``max_mv`` only."""
        unknown = set(args) - {"max_mv"}
        if unknown:
            raise RuntimeError(f"scan_mvs takes no {sorted(unknown)}")
        self._asked.max_mv = int(args.get("max_mv", DEFAULT_MAX_MV))

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

    def serve(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(fields int16 [N, max_mv, 4], counts int32 [N]) at the capacity
        the last ``check`` on this thread asked for."""
        cap = getattr(self._asked, "max_mv", DEFAULT_MAX_MV)
        fields, counts = self.pool
        if cap <= fields.shape[1]:
            out = fields[idx, :cap]
        else:
            out = np.zeros((len(idx), cap, 4), np.int16)
            out[:, :fields.shape[1]] = fields[idx]
        c = counts[idx]
        return out, np.where(c > cap, -c, c).astype(np.int32)
