"""MVClusterDetector — the motion detector of the MV scan paths.

The bits/words/grids part of ``mvtrim_tpu/models/mv_detector.py``:
bit-packed activity masks (or their int32 word layout), or uint8 vote
grids, go to the device in batches of ``device_batch`` frames, and each
batch comes back as per-frame motion booleans.  Dispatch is asynchronous:
``scan_*_async`` returns a zero-argument resolver that waits for its
batches and returns motion [N], so the pipeline's feeder overlaps device
work with host decode.
"""

from __future__ import annotations

import numpy as np
import torch

from mvtrim_tpu.core import oracle
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.core.types import GridGeometry

from ..ops import cluster as cluster_ops

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


def stage_and_decide(rows: np.ndarray, device: torch.device, op):
    """Stage one batch in pinned host memory, copy it to ``device``
    without blocking, decide it with ``op(tensor) -> motion bool``, and
    copy the motion back into a pinned buffer behind an event.

    Returns (host, pending) with pending = (done, staged, on_device,
    motion): the caller keeps ``pending`` until it has waited on ``done``
    (the pinned ``staged`` must not be reused while its copy may still
    run), then reads ``host``.
    """
    staged = torch.from_numpy(rows).pin_memory()
    on_device = staged.to(device, non_blocking=True)
    motion = op(on_device)
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

    # --- a path outside the ported slices ---

    def scan_raw_mvs_async(self, mvs: np.ndarray, counts: np.ndarray):
        raise RuntimeError(
            "the raw-MV payload (MVT_SCAN_INPUT=mv_raw) is not ported to "
            "mvtrim_tpu_torch yet: ROADMAP.md queue 1 item 8")

    # --- forward over bit-packed activity masks (default path) ---

    def scan_bits_async(self, bits: np.ndarray):
        """Dispatch bit-packed activity masks uint8 [N, gh, ceil(gw/8)]
        (native mvt_scan_bits layout); return a resolver for motion [N].

        The mask is the host-side ``votes >= vectors_needed`` threshold,
        and the cluster rule reads votes only through that comparison
        (motion_scanner.cpp:277-293).  Frames are re-packed to 32-cell
        int32 words (repack_bits_words) per batch, on the host.
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

        return self._dispatch(
            lambda lo, hi: cluster_ops.repack_bits_words(
                bits[lo:hi], self.geom), n, self._words_op)

    def scan_bits(self, bits: np.ndarray) -> np.ndarray:
        """Host entry: packed masks uint8 [N, gh, gwb] -> motion bool [N]."""
        return self.scan_bits_async(bits)()

    def _words_op(self, words: torch.Tensor) -> torch.Tensor:
        return cluster_ops.cluster_words_op(
            words, self.geom, self.cfg.clusters_needed)[1]

    def _dispatch(self, get_rows, n: int, op):
        """The one batch/dispatch/resolve loop, shared by the bits, words
        and grids inputs.  ``get_rows(lo, hi)`` supplies each batch as a
        numpy array and ``op(tensor) -> motion bool`` decides it.

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
            rows = np.ascontiguousarray(get_rows(lo, hi))
            if self.backend == "torch":
                futures.append((lo, hi, op(torch.from_numpy(rows)), None))
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
        scan_bits_async, without the per-batch repack."""
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
