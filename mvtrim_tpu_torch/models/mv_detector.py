"""MVClusterDetector — the motion detector of the MV scan paths.

The counterpart of ``mvtrim_tpu/models/mv_detector.py``: bit-packed
activity masks (or their int32 word layout), uint8 vote grids, or raw MV
fields go to the device in batches of ``device_batch`` frames, and each
batch comes back as per-frame motion booleans.  Dispatch is asynchronous:
``scan_*_async`` returns a zero-argument resolver that waits for its
batches and returns motion [N], so the pipeline's feeder overlaps device
work with host decode.  ``staging`` says how each batch reaches the card.
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
from . import staging


class MVClusterDetector:
    """Per-video detector: packed activity masks -> motion decisions."""

    def __init__(self, width: int, height: int, cfg: Config | None = None,
                 device=None):
        self.cfg = cfg or Config.from_env()
        self.geom = GridGeometry.build(width, height, self.cfg)
        self.backend, self.device = staging.placement(
            self.cfg.scan_backend, device)
        self.device_batch = max(1, self.cfg.device_batch)

    # --- forward over host-scattered vote grids (grids payload) ---

    def scan_votes_async(self, grids: np.ndarray):
        """Dispatch vote grids uint8 [N, gh, gw]; return a resolver for
        motion [N].  A cell is active at votes >= VECTORS_NEEDED, and
        the vote-level cluster rule decides each frame."""
        n = grids.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        if self.backend == "oracle":
            return self._oracle(grids, self.cfg.vectors_needed)

        def op(votes):
            return cluster_ops.cluster_map_op(
                votes, self.geom, self.cfg.vectors_needed,
                self.cfg.clusters_needed)[1]

        return self._dispatch(op, grids)

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
        range with a larger capacity first (the pipeline's ``MvRaw``
        payload does).  We refuse to guess.
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
        return self._dispatch(op, mvs, counts)

    def scan_raw_mvs(self, mvs: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Host entry for the raw-MV path (see scan_raw_mvs_async)."""
        return self.scan_raw_mvs_async(mvs, counts)()

    # --- forward over bit-packed activity masks (default path) ---

    def scan_bits_async(self, bits: np.ndarray):
        """Dispatch bit-packed activity masks uint8 [N, gh, ceil(gw/8)]
        (native mvt_scan_bits layout); return a resolver for motion [N].

        The mask is the host-side ``votes >= vectors_needed`` threshold,
        and the cluster rule reads votes only through that comparison
        (motion_scanner.cpp:277-293).  The kernel reads the rows at their
        own byte pitch, so nothing is re-packed on the host."""
        n = bits.shape[0]
        if n == 0:
            return lambda: np.zeros((0,), bool)
        if self.backend == "oracle":
            return self._oracle(np.unpackbits(
                bits, axis=2, bitorder="little")[:, :, :self.geom.gw], 1)
        if self.device.type == "cuda":
            return self._dispatch_staged(bits, np.uint8, (
                self.geom.gh, (self.geom.gw + 7) // 8))
        return self._dispatch(self._bits_op, bits)

    def scan_bits(self, bits: np.ndarray) -> np.ndarray:
        """Host entry: packed masks uint8 [N, gh, gwb] -> motion bool [N]."""
        return self.scan_bits_async(bits)()

    def _oracle(self, grids: np.ndarray, vectors_needed: int):
        """The NumPy cluster rule over vote grids, as a resolver."""
        counts = oracle.count_clusters_batch(
            grids, vectors_needed=vectors_needed,
            y_min=self.geom.y_min, y_max=self.geom.y_max)
        motion = counts >= oracle.effective_clusters_needed(
            self.cfg.clusters_needed)
        return lambda: motion

    def _bits_op(self, bits: torch.Tensor) -> torch.Tensor:
        return cluster_ops.cluster_bits_op(
            bits, self.geom, self.cfg.clusters_needed)[1]

    def _words_op(self, words: torch.Tensor) -> torch.Tensor:
        return cluster_ops.cluster_words_op(
            words, self.geom, self.cfg.clusters_needed)[1]

    def _dispatch_staged(self, rows: np.ndarray, dtype, shape: tuple):
        """The bits or words payload (K1) on the card: rows ``dtype`` [N,
        *shape] through the card's slots (``staging.dispatch``, enqueued
        by ``cluster_ops.cluster_staged_op``)."""
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

    def _dispatch(self, op, *arrays):
        """The batch/dispatch/resolve loop over ``staging.stage_and_decide``:
        the ``arrays`` [N, ...] in batches of ``device_batch`` frames, each
        decided by ``op(*tensors) -> motion bool``; a second array holds
        the rows of each frame that ``op`` reads (the raw-MV counts).  On
        CUDA each future holds the batch's motion buffer and event until
        the resolver has waited on it.
        """
        n, db = arrays[0].shape[0], self.device_batch
        futures = []
        for lo in range(0, n, db):
            hi = min(lo + db, n)
            rows = tuple(a[lo:hi] for a in arrays)
            futures.append((lo, hi) + staging.stage_and_decide(
                rows, self.device, op, rows[1] if len(rows) > 1 else None))

        def resolve():
            out = np.zeros((n,), bool)
            for lo, hi, motion, pending in futures:
                staging.wait(pending)
                out[lo:hi] = motion.numpy()
            return out

        return resolve

    def scan_words_async(self, words: np.ndarray):
        """Dispatch word-layout activity masks int32 [N, gh*gww] (the
        native mvt_scan_words output — already the kernel's word layout);
        return a resolver for motion [N], deciding as scan_bits_async
        does on the same masks."""
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
        return self._dispatch(self._words_op, words)

    def scan_words(self, words: np.ndarray) -> np.ndarray:
        """Host entry: word-layout masks int32 [N, gh*gww] -> motion [N]."""
        return self.scan_words_async(words)()
