"""MVClusterDetector — the motion detector of the MV scan paths.

The counterpart of ``mvtrim_tpu/models/mv_detector.py``: bit-packed
activity masks (or their int32 word layout), uint8 vote grids, or raw MV
fields go to the device in batches of ``device_batch`` frames, and each
batch comes back as per-frame motion booleans.  Dispatch is asynchronous:
``scan_*_async`` returns a zero-argument resolver that waits for its
batches and returns motion [N], so the pipeline's feeder overlaps device
work with host decode.  On a card the bits and words payloads (K1) are
staged in the card's pinned slots (``staging``); the grids and raw-MV
payloads, and the SAD detector, go through ``stage_and_decide``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import cluster as cluster_ops
from ..ops import mv_vote
from ..utils.timing import SPANS
from . import staging

BACKENDS = ("auto", "torch", "oracle")


def resolve_backend(requested: str) -> str:
    """auto -> cuda, which needs a CUDA device; torch (the plain PyTorch
    build on the CPU) and oracle (the NumPy reference) pass through."""
    if requested not in BACKENDS:
        raise RuntimeError(
            f"MVT_SCAN_BACKEND={requested!r} is not one of "
            f"{', '.join(BACKENDS)}")
    if requested == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "MVT_SCAN_BACKEND=auto needs a CUDA device and none is "
                "available; set MVT_SCAN_BACKEND=torch for the CPU build")
        return "cuda"
    return requested


def stage_and_decide(rows, device: torch.device, op, live_rows=None):
    """Stage one batch, decide it with ``op(tensor) -> motion bool`` on
    ``device``, and return (host, pending).  ``rows`` is one numpy array,
    or a tuple of them that ``op`` takes in order; ``live_rows`` (the
    raw-MV payload's counts) the rows of each frame that ``op`` reads.

    On a CPU device the op runs on the rows in place: ``host`` is the
    motion and ``pending`` None.  On CUDA each array is staged in pinned
    host memory, copied to the card without blocking, decided, and the
    motion is copied back into a pinned ``host`` buffer behind an event;
    pending = (done,), which the caller waits on (``wait``) before it
    reads ``host``.  The staged and device copies are dropped here: the
    host allocator keeps a pinned block from reuse until the event it
    records on the block's copy has passed, and the card's caching
    allocator orders a freed block's reuse after the work queued on its
    stream, the current one.  So a caller that holds many batches (the
    feeder holds a file's) holds their motion, not their rows.

    On a card this stages the grids and raw-MV payloads and the SAD
    detector's windows, a block of the host allocator's cache a batch: the
    SAD scan decides each window (up to about 267 MB) on the spot and the
    raw-MV batches change size with the MV capacity, so neither suits the
    reused slots of the bits and words payloads (``staging``), whose
    batches of about 1 KB a frame a file holds until its scan ends.

    Spans: ``detector.stage`` (value: bytes staged), inside it
    ``detector.mv_rows`` where ``live_rows`` is given (zero-length; value:
    their sum), and ``detector.enqueue`` (value: frames; its launches are
    the kernels').
    """
    cuda = device.type == "cuda"
    span = SPANS.begin("detector.stage") if SPANS.on else None
    if span is not None and live_rows is not None:
        SPANS.end(SPANS.begin("detector.mv_rows"), int(live_rows.sum()))
    arrays = rows if isinstance(rows, tuple) else (rows,)
    staged = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    if cuda:
        staged = tuple(t.pin_memory() for t in staged)
    if span is not None:
        SPANS.end(span, sum(t.nbytes for t in staged))
    span = SPANS.begin("detector.enqueue") if SPANS.on else None
    if not cuda:
        host, pending = op(*staged), None
    else:
        on_device = tuple(t.to(device, non_blocking=True) for t in staged)
        motion = op(*on_device)
        host = torch.empty(motion.shape, dtype=torch.bool, pin_memory=True)
        host.copy_(motion, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        pending = (done,)
    if span is not None:
        SPANS.end(span, staged[0].shape[0])
    return host, pending


def wait(pending) -> None:
    """Wait for a batch that ``stage_and_decide`` left pending (span
    ``detector.wait``); a batch decided on the CPU has nothing to wait
    for."""
    if pending is None:
        return
    span = SPANS.begin("detector.wait") if SPANS.on else None
    pending[0].synchronize()
    if span is not None:
        SPANS.end(span)


class MVClusterDetector:
    """Per-video detector: packed activity masks -> motion decisions."""

    def __init__(self, width: int, height: int, cfg: Config | None = None,
                 device=None):
        self.cfg = cfg or Config.from_env()
        self.geom = GridGeometry.build(width, height, self.cfg)
        self.backend = resolve_backend(self.cfg.scan_backend)
        self.device_batch = max(1, self.cfg.device_batch)
        # device= pins this detector to one card (batch mode spreads
        # streams over the cards); the torch backend always runs on the CPU
        if self.backend == "cuda":
            self.device = torch.device(device if device is not None
                                       else "cuda")
        else:
            self.device = torch.device("cpu")

    # --- forward over host-scattered vote grids (grids payload) ---

    def scan_votes_async(self, grids: np.ndarray):
        """Dispatch vote grids uint8 [N, gh, gw]; return a resolver for
        motion [N].  A cell is active at votes >= VECTORS_NEEDED, and
        the vote-level cluster rule decides each frame."""
        n = grids.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        if self.backend == "oracle":
            counts = oracle.count_clusters_batch(
                grids, vectors_needed=self.cfg.vectors_needed,
                y_min=self.geom.y_min, y_max=self.geom.y_max)
            motion = counts >= oracle.effective_clusters_needed(
                self.cfg.clusters_needed)
            return lambda: motion

        def op(votes):
            return cluster_ops.cluster_map_op(
                votes, self.geom, self.cfg.vectors_needed,
                self.cfg.clusters_needed)[1]

        return self._dispatch(lambda lo, hi: grids[lo:hi], n, op)

    def scan_votes(self, grids: np.ndarray) -> np.ndarray:
        """Host entry: vote grids uint8 [N, gh, gw] -> motion bool [N]."""
        return self.scan_votes_async(grids)()

    # --- forward over raw MV fields (mv_raw payload) ---

    def decide_raw_mvs_on_host(self, mvs: np.ndarray,
                               counts: np.ndarray) -> np.ndarray:
        """The NumPy oracle (``oracle.check_frame``) over raw MV fields
        int16 [N, M, 4] + counts int32 [N] >= 0 -> motion bool [N]."""
        g, cfg = self.geom, self.cfg
        return np.array([
            oracle.check_frame(
                mvs[i, :counts[i]].astype(np.int64), g.gw, g.gh,
                threshold_sq=cfg.mv_threshold_sq,
                block_shift=cfg.block_shift, y_min=g.y_min, y_max=g.y_max,
                vectors_needed=cfg.vectors_needed,
                clusters_needed=cfg.clusters_needed)
            for i in range(len(counts))], dtype=bool)

    def scan_raw_mvs_async(self, mvs: np.ndarray, counts: np.ndarray):
        """Dispatch raw MV fields int16 [N, M, 4] + counts int32 [N];
        return a resolver for motion bool [N].  The fused raw-MV kernel
        thresholds, scatters and clusters on the device.

        Exactness contract: a negative count means the native scanner
        truncated that frame's MV list to the M capacity, so a decision
        over it could differ from the reference — callers MUST re-scan the
        range with a larger capacity first (the pipeline's mv_raw worker
        restarts the chunk at once at the power of two that holds its
        largest count).  We refuse to guess.
        """
        n = mvs.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        overflow = np.nonzero(counts < 0)[0]
        if overflow.size:
            need = int(-counts[overflow].min())
            raise ValueError(
                f"{overflow.size} frame(s) overflowed the MV capacity "
                f"M={mvs.shape[1]} (max real count {need}); re-scan with "
                f"a larger max_mv — a truncated list cannot be decided "
                f"exactly")
        if self.backend == "oracle":
            motion = self.decide_raw_mvs_on_host(mvs, counts)
            return lambda: motion
        bound = mv_vote.threshold_bound(self.cfg.mv_threshold_sq)

        def op(fields, cnts):
            return mv_vote.mv_cluster_op(
                fields, cnts, self.geom, bound, self.cfg.vectors_needed,
                self.cfg.clusters_needed, self.cfg.block_shift)[1]

        # the kernel takes B and M at run time: each dispatch sends exactly
        # its frames, at whatever capacity M the scan was made with
        return self._dispatch(lambda lo, hi: (mvs[lo:hi], counts[lo:hi]), n,
                              op, counted=True)

    def scan_raw_mvs(self, mvs: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Host entry for the raw-MV path (see scan_raw_mvs_async)."""
        return self.scan_raw_mvs_async(mvs, counts)()

    # --- forward over bit-packed activity masks (default path) ---

    def scan_bits_async(self, bits: np.ndarray):
        """Dispatch bit-packed activity masks uint8 [N, gh, ceil(gw/8)]
        (native mvt_scan_bits layout); return a resolver for motion [N].

        The mask is the host-side ``votes >= vectors_needed`` threshold,
        and the cluster rule reads votes only through that comparison
        (motion_scanner.cpp:277-293).  Batches go to the card as they come:
        the kernel reads the rows at their own byte pitch, so nothing is
        re-packed on the host.  On a card each batch is staged in a slot of
        the card's pool and enqueued by one native call
        (``_dispatch_staged``); the slots go back once the resolver has
        waited on them.
        """
        n = bits.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        if self.backend == "oracle":
            active = np.unpackbits(
                bits, axis=2, bitorder="little")[:, :, :self.geom.gw]
            counts = oracle.count_clusters_batch(
                active, vectors_needed=1,
                y_min=self.geom.y_min, y_max=self.geom.y_max)
            motion = counts >= oracle.effective_clusters_needed(
                self.cfg.clusters_needed)
            return lambda: motion

        if self.device.type == "cuda":
            return self._dispatch_staged(bits, np.uint8, (
                self.geom.gh, (self.geom.gw + 7) // 8))
        return self._dispatch(lambda lo, hi: bits[lo:hi], n, self._bits_op)

    def scan_bits(self, bits: np.ndarray) -> np.ndarray:
        """Host entry: packed masks uint8 [N, gh, gwb] -> motion bool [N]."""
        return self.scan_bits_async(bits)()

    def _bits_op(self, bits: torch.Tensor) -> torch.Tensor:
        return cluster_ops.cluster_bits_op(
            bits, self.geom, self.cfg.clusters_needed)[1]

    def _words_op(self, words: torch.Tensor) -> torch.Tensor:
        return cluster_ops.cluster_words_op(
            words, self.geom, self.cfg.clusters_needed)[1]

    def _dispatch_staged(self, rows: np.ndarray, dtype, shape: tuple):
        """The bits or words payload (K1) on the card: rows ``dtype`` [N,
        *shape], each device batch staged in a slot of the card's pool and
        enqueued by one native call (``staging.dispatch``,
        ``cluster_ops.cluster_staged_op``); the resolver waits on each
        slot's event and hands the slots back."""
        if rows.dtype != dtype:
            raise TypeError(f"rows must be {np.dtype(dtype)}, got "
                            f"{rows.dtype}")
        if rows.shape[1:] != shape:
            raise ValueError(f"rows must be [N, {', '.join(map(str, shape))}]"
                             f", got {rows.shape}")
        pitch = rows.nbytes // (rows.shape[0] * self.geom.gh)
        enqueue = functools.partial(
            cluster_ops.cluster_staged_op, geom=self.geom, pitch=pitch,
            clusters_needed=self.cfg.clusters_needed)
        return staging.dispatch(staging.pool_for(self.device), rows,
                                self.device_batch, enqueue)

    def _dispatch(self, get_rows, n: int, op, counted: bool = False):
        """The batch/dispatch/resolve loop of the grids and raw-MV inputs,
        and of the bits and words inputs on the CPU (on a card they take
        ``_dispatch_staged``).  ``get_rows(lo, hi)`` supplies each batch
        as a numpy array, or a tuple of them, and ``op(*tensors) -> motion
        bool`` decides it; ``counted``: the second array holds the rows of
        each frame that ``op`` reads (the raw-MV counts).

        Each batch goes through ``stage_and_decide``; on CUDA each future
        holds the batch's motion buffer and event until the resolver has
        waited on it.
        """
        db = self.device_batch
        futures = []
        for lo in range(0, n, db):
            hi = min(lo + db, n)
            rows = get_rows(lo, hi)
            futures.append((lo, hi) + stage_and_decide(
                rows, self.device, op, rows[1] if counted else None))

        def resolve():
            out = np.zeros((n,), bool)
            for lo, hi, motion, pending in futures:
                wait(pending)
                out[lo:hi] = motion.numpy()
            return out

        return resolve

    def scan_words_async(self, words: np.ndarray):
        """Dispatch word-layout activity masks int32 [N, gh*gww] (the
        native mvt_scan_words output — already the kernel's word layout);
        return a resolver for motion [N].  Identical decisions to
        scan_bits_async on the same masks, and staged on a card as they
        are (``_dispatch_staged``)."""
        n = words.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        used = cluster_ops.word_geometry(self.geom)[1]
        if words.shape[1] != used:
            raise ValueError(f"words must be [N, {used}], got {words.shape}")
        if self.backend == "oracle":
            gwb = (self.geom.gw + 7) // 8
            bits = words.view(np.uint8).reshape(n, self.geom.gh, -1)[
                :, :, :gwb]
            return self.scan_bits_async(np.ascontiguousarray(bits))
        if self.device.type == "cuda":
            return self._dispatch_staged(words, np.int32, (used,))
        return self._dispatch(lambda lo, hi: words[lo:hi], n, self._words_op)

    def scan_words(self, words: np.ndarray) -> np.ndarray:
        """Host entry: word-layout masks int32 [N, gh*gww] -> motion [N]."""
        return self.scan_words_async(words)()
