"""MVClusterDetector — the motion detector of the MV scan paths.

The counterpart of ``mvtrim_tpu/models/mv_detector.py``: bit-packed
activity masks (or their int32 word layout), uint8 vote grids, or raw MV
fields go to the device in batches of ``device_batch`` frames, and each
batch comes back as per-frame motion booleans.  Dispatch is asynchronous:
``scan_*_async`` returns a zero-argument resolver that waits for its
batches and returns motion [N], so the pipeline's feeder overlaps device
work with host decode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import cluster as cluster_ops
from ..ops import mv_vote

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


def stage_and_decide(rows, device: torch.device, op):
    """Stage one batch in pinned host memory, copy it to ``device``
    without blocking, decide it with ``op(tensor) -> motion bool``, and
    copy the motion back into a pinned buffer behind an event.  ``rows``
    is one numpy array, or a tuple of them that ``op`` takes in order.

    Returns (host, pending) with pending = (done, staged, on_device,
    motion): the caller keeps ``pending`` until it has waited on ``done``
    (the pinned ``staged`` must not be reused while its copy may still
    run), then reads ``host``.
    """
    arrays = rows if isinstance(rows, tuple) else (rows,)
    staged = tuple(torch.from_numpy(a).pin_memory() for a in arrays)
    on_device = tuple(t.to(device, non_blocking=True) for t in staged)
    motion = op(*on_device)
    host = torch.empty(motion.shape, dtype=torch.bool, pin_memory=True)
    host.copy_(motion, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, (done, staged, on_device, motion)


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
        does, doubling until clean).  We refuse to guess.
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
                              op)

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
        re-packed on the host.
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

    def _dispatch(self, get_rows, n: int, op):
        """The one batch/dispatch/resolve loop, shared by the bits, words,
        grids and raw-MV inputs.  ``get_rows(lo, hi)`` supplies each batch
        as a numpy array, or a tuple of them, and ``op(*tensors) -> motion
        bool`` decides it.

        On CUDA each batch is staged in pinned host memory, copied to the
        card without blocking, decided by the kernel, and its motion is
        copied back into a pinned buffer behind an event.  Each future
        holds its staging buffers until the resolver has waited on that
        event: a pinned buffer must not be reused while a copy from it
        may still run.
        """
        db = self.device_batch
        futures = []
        for lo in range(0, n, db):
            hi = min(lo + db, n)
            rows = get_rows(lo, hi)
            rows = (tuple(np.ascontiguousarray(r) for r in rows)
                    if isinstance(rows, tuple) else
                    np.ascontiguousarray(rows))
            if self.backend == "torch":
                arrays = rows if isinstance(rows, tuple) else (rows,)
                futures.append((lo, hi, op(*map(torch.from_numpy, arrays)),
                                None))
                continue
            futures.append((lo, hi) + stage_and_decide(rows, self.device,
                                                       op))

        def resolve():
            out = np.zeros((n,), bool)
            for lo, hi, motion, pending in futures:
                if pending is not None:
                    pending[0].synchronize()
                out[lo:hi] = motion.numpy()
            return out

        return resolve

    def scan_words_async(self, words: np.ndarray):
        """Dispatch word-layout activity masks int32 [N, gh*gww] (the
        native mvt_scan_words output — already the kernel's word layout);
        return a resolver for motion [N].  Identical decisions to
        scan_bits_async on the same masks."""
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
        return self._dispatch(lambda lo, hi: words[lo:hi], n, self._words_op)

    def scan_words(self, words: np.ndarray) -> np.ndarray:
        """Host entry: word-layout masks int32 [N, gh*gww] -> motion [N]."""
        return self.scan_words_async(words)()
