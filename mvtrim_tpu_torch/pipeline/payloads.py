"""The scan's payloads.  A class a payload holds its reader mode, scan
method and arguments, the frames a call may take, the warm-up batch, the
decode of a chunk, the dispatch of a part to the detector and a part's
heatmap activity.  ``choose`` picks the class; an instance serves one
``_parallel_scan`` call: its detector and its decode workers."""

from __future__ import annotations

import math
import threading
from types import SimpleNamespace

import numpy as np

from ..core.config import Config
from ..io import native
from ..models.mv_detector import MVClusterDetector
from ..models.sad_detector import SADDetector
from ..ops.cluster import word_geometry
from ..utils import logging as log
from ..utils.timing import SPANS


class Payload:
    """A scan's payload; each subclass names the reader's scan ``method``
    and the detector's ``entry``, which ``dispatch`` looks up on every
    call, and has a ``warm_up``."""

    mode = native.MVT_MODE_MV
    method = entry = ""
    label = "Parallel Scan"           # the scan's phase line
    detector_class = MVClusterDetector
    activity = None                   # a part's active cells, [gh, gw]

    def __init__(self, cfg: Config, width: int, height: int, fps: float,
                 n_threads: int, device=None):
        self.cfg = cfg
        self.detector = self.detector_class(width, height, cfg,
                                            device=device)
        self.geom = self.detector.geom
        self.frame_skip = cfg.frame_skip(fps)
        cap = (cfg.chunk_frames_cap if cfg.chunk_frames_cap > 0
               else self.frame_cap(width, height, n_threads))
        self.max_frames = min(cap, int(math.ceil(
            cfg.chunk_duration_sec * max(fps, 1.0))) + 64)

    def frame_cap(self, width: int, height: int, n_threads: int) -> int:
        return 1 << 30  # unless MVT_CHUNK_FRAMES_CAP sets it

    def begin(self, timing, file_id):
        return None

    def args(self, chunk) -> dict:
        return {}

    def part(self, out, chunk):
        return out

    def dispatch(self, data):
        return getattr(self.detector, self.entry)(data)

    def decode(self, scan, task, put, timing, file_id) -> None:
        """Decode ``task``'s chunk by the reader's ``scan`` and ``put`` each
        part, (data, pts), for the feeder; a ``scan.decode`` span a call
        (value: its frames).  ``begin`` makes the chunk's state, ``args``
        a call's own arguments, ``part`` the part of a call's output, or
        None to decode the chunk again from a fresh seek.  A call that took
        ``max_frames`` is resumed (``resume=True``: the exact stream
        position and frame-skip count), so a capped chunk analyzes the
        uncapped scan's frames (motion_scanner.cpp:314,356-357)."""
        chunk = self.begin(timing, file_id)
        resume = False
        while True:
            span = SPANS.begin("scan.decode", file_id) if SPANS.on else None
            out = scan(task.start, task.end, **self.args(chunk),
                       frame_skip=self.frame_skip,
                       max_frames=self.max_frames, timing=timing,
                       resume=resume)
            n = len(out[-1])
            if span is not None:
                SPANS.end(span, n)
            part = self.part(out, chunk)
            if part is None:
                resume = False
                continue
            if n == 0:
                break
            if len(part[1]):  # empty after a duplicate drop
                put(part)
            if n < self.max_frames:
                break
            resume = True


class _Masks(Payload):
    """The MV payloads the native scan scatters on the host's grid."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        g, cfg = self.geom, self.cfg
        self.scan_args = dict(
            threshold_sq=cfg.mv_threshold_sq, block_shift=cfg.block_shift,
            gw=g.gw, gh=g.gh, y_min=g.y_min, y_max=g.y_max)

    def args(self, chunk) -> dict:
        return self.scan_args


class Bits(_Masks):
    """Host-thresholded activity masks, bit-packed, uint8 [N, gh,
    ceil(gw/8)] (the default)."""

    method, entry = "scan_bits", "scan_bits_async"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.scan_args["vectors_needed"] = self.cfg.vectors_needed

    def warm_up(self) -> None:
        self.detector.scan_bits(np.zeros(
            (1, self.geom.gh, (self.geom.gw + 7) // 8), np.uint8))

    def activity(self, data: np.ndarray) -> np.ndarray:
        return np.unpackbits(data, axis=2, bitorder="little")[
            :, :, :self.geom.gw].sum(axis=0, dtype=np.int64)


class Words(Bits):
    """The same masks in the kernel's int32 word layout [N, gh * gww],
    repacked in the GIL-released decode workers."""

    method, entry = "scan_words", "scan_words_async"

    def warm_up(self) -> None:
        self.detector.scan_words(
            np.zeros((1, word_geometry(self.geom)[1]), np.int32))

    def activity(self, data: np.ndarray) -> np.ndarray:
        # the bits' little-endian layout viewed as int32 lanes
        return super().activity(
            data.view(np.uint8).reshape(len(data), self.geom.gh, -1))


class Grids(_Masks):
    """uint8 vote grids [N, gh, gw], thresholded on the device by the
    cluster-map kernel."""

    method, entry = "scan_grids", "scan_votes_async"

    def warm_up(self) -> None:
        self.detector.scan_votes(np.zeros((1, self.geom.gh, self.geom.gw),
                                          np.uint8))

    def activity(self, data: np.ndarray) -> np.ndarray:
        return (data >= self.cfg.vectors_needed).sum(axis=0, dtype=np.int64)


def mv_restart_capacity(largest: int, unseen: bool = False) -> int:
    """The capacity a raw-MV chunk is decoded again at once a call
    overflowed, from the largest MV count of that call: an eighth of
    headroom over it in steps of 1,024 rows, so a steady camera's next
    chunks fit too, and never more than the power of two that holds it.
    Where the call stopped at its frame cap with frames of the chunk
    still ``unseen``, whose counts may be larger, it is that power of
    two, so a chunk decoded in sub-calls restarts where and as often as
    it does at the power of two alone."""
    pow2 = 1 << (largest - 1).bit_length()
    if unseen:
        return pow2
    return min(pow2, -(-(largest + largest // 8) // 1024) * 1024)


class MvRaw(Payload):
    """Raw MV fields int16 [N, M, 4] + counts int32 [N], voted on the
    device by the fused raw-MV kernel.  M is the file's capacity, shared
    by its decode workers: it starts at MVT_MV_CAPACITY and only grows,
    so a noisy camera's later chunks start at a capacity that holds them
    (span ``scan.mv_carried``).  A call that overflows it decodes the WHOLE
    chunk again at ``mv_restart_capacity`` of its largest count and raises
    the file's capacity to that; decode is deterministic, so the restart
    drops the replayed frames and rewinds frames_with_mvs."""

    method, entry = "scan_mvs", "scan_raw_mvs_async"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.capacity = self.cfg.mv_capacity
        self._lock = threading.Lock()

    def warm_up(self) -> None:
        self.detector.scan_raw_mvs(
            np.zeros((1, self.cfg.mv_capacity, 4), np.int16),
            np.zeros((1,), np.int32))

    def begin(self, timing, file_id) -> SimpleNamespace:
        # capacity, frames queued, replayed ones to drop, frames_with_mvs
        chunk = SimpleNamespace(cap=self.capacity, emitted=0, skip=0,
                                timing=timing, mv_base=timing.frames_with_mvs)
        if SPANS.on and chunk.cap > self.cfg.mv_capacity:
            SPANS.end(SPANS.begin("scan.mv_carried", file_id), chunk.cap)
        return chunk

    def args(self, chunk: SimpleNamespace) -> dict:
        return {"max_mv": chunk.cap}

    def part(self, out, chunk: SimpleNamespace):
        mvs, counts, pts = out
        n = len(pts)
        if n and (counts < 0).any():
            chunk.cap = mv_restart_capacity(int(-counts.min()),
                                            unseen=n == self.max_frames)
            with self._lock:
                self.capacity = max(self.capacity, chunk.cap)
            if SPANS.on:
                # zero-length: the frames decoded in vain (this call's and
                # the queued ones the restart decodes again and drops), and
                # the capacity chosen, in the name
                SPANS.end(SPANS.begin("scan.mv_restart"), n + chunk.emitted)
                SPANS.end(SPANS.begin(f"scan.mv_capacity.{chunk.cap}"),
                          chunk.cap)
            chunk.skip = chunk.emitted
            chunk.timing.frames_with_mvs = chunk.mv_base
            return None
        k = min(chunk.skip, n)
        chunk.skip -= k
        chunk.emitted += n - k
        return (mvs[k:], counts[k:]), pts[k:]

    def dispatch(self, data):
        return getattr(self.detector, self.entry)(*data)


class Luma(Payload):
    """Luma planes uint8 [N, H, W] for the SAD detector; a sub-scan's
    carry is the one before's last frame, so a cap changes no decision."""

    mode = native.MVT_MODE_LUMA
    method, entry = "scan_luma", "scan_luma"
    label = "Parallel SAD Scan"
    detector_class = SADDetector

    def frame_cap(self, width: int, height: int, n_threads: int) -> int:
        # luma is H*W bytes a frame: 512 MiB a call over the workers
        return max(16, (512 * 1024 * 1024) // max(1, width * height)
                   // max(1, n_threads))

    def warm_up(self) -> None:
        self.detector.scan_luma(np.zeros(
            (2, self.detector.height, self.detector.width), np.uint8))

    def begin(self, timing, file_id) -> list:
        return [None]  # the carry

    def part(self, out, carry: list):
        luma, pts = out
        part = (luma, carry[0]), pts
        if len(luma):
            carry[0] = luma[-1].copy()
        return part

    def dispatch(self, data):
        # the SAD scan decides each sub-scan on the spot
        motion = getattr(self.detector, self.entry)(data[0], carry=data[1])
        return lambda: motion


MV_PAYLOADS = {"bits": Bits, "words": Words, "grids": Grids,
               "mv_raw": MvRaw}


def choose(kind: str, cfg: Config, stream_id: int = -1) -> type[Payload]:
    """The payload of a scan of ``kind``: luma for the SAD scan; for the
    MV scan, MVT_SCAN_INPUT's (bits, words, grids or mv_raw)."""
    if kind != "mv":
        return Luma
    scan_input = cfg.scan_input
    if scan_input not in MV_PAYLOADS:
        log.warn(f"Unknown MVT_SCAN_INPUT={scan_input!r}; using bits",
                 stream_id)
        return Bits
    if scan_input == "grids" and cfg.vectors_needed == 0:
        # raw vote grids cannot tell "no MV side data" from "side data
        # but every MV filtered" at vec_need 0; the packed masks can,
        # and decide identically otherwise
        log.info("VECTORS_NEEDED=0: vote grids are ambiguous for "
                 "MV-less frames; using the bits payload "
                 "(identical decisions)", stream_id)
        return Bits
    if scan_input == "mv_raw" and cfg.heatmap_path:
        log.warn("MVT_HEATMAP is unavailable with MVT_SCAN_INPUT="
                 "mv_raw (no per-cell grids on host); skipping heatmap",
                 stream_id)
    return MV_PAYLOADS[scan_input]
