"""SADDetector — the pixel-domain fallback detector (no codec MVs needed).

The counterpart of ``mvtrim_tpu/models/sad_detector.py``: decoded luma
planes go through the block-SAD op (``ops/sad.py``).  Within a chunk, each
analyzed frame is compared to the previous analyzed frame; a chunk's first
frame has no predecessor and is never motion unless the caller hands in
the frame before it as ``carry`` (the pipeline does so across cap-resumed
sub-scans).  Chunks stay independent, so host decode stays parallel.

Backends: ``auto`` runs the CUDA kernels and raises without a GPU;
``torch`` runs the plain PyTorch versions on the CPU; ``oracle`` maps to
the plain versions too, as the JAX package maps it to its XLA build.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import sad as sad_ops
from .mv_detector import resolve_backend, stage_and_decide, wait


def sad_oracle_counts(luma: np.ndarray, geom: GridGeometry, *,
                      sad_threshold: float, block_size: int) -> np.ndarray:
    """NumPy contract for the SAD path: counts[i] for frame i+1 vs i."""
    x = luma.astype(np.int64)
    diff = np.abs(x[1:] - x[:-1])
    n = diff.shape[0]
    gh, gw = geom.gh, geom.gw
    sad = np.zeros((n, gh, gw), np.int64)
    for by in range(gh):
        for bx in range(gw):
            blk = diff[:, by * block_size:(by + 1) * block_size,
                       bx * block_size:(bx + 1) * block_size]
            sad[:, by, bx] = blk.sum(axis=(1, 2))
    bound = sad_ops.sad_threshold_sum(sad_threshold, block_size)
    active = (sad >= bound).astype(np.uint8)
    # reuse the cluster rule with votes=1, threshold=1
    return oracle.count_clusters_batch(active, vectors_needed=1,
                                       y_min=geom.y_min, y_max=geom.y_max)


class SADDetector:
    """Per-video pixel-domain detector: luma frames -> motion decisions."""

    def __init__(self, width: int, height: int, cfg: Config | None = None,
                 device=None):
        self.cfg = cfg or Config.from_env()
        self.geom = GridGeometry.build(width, height, self.cfg)
        self.width = width
        self.height = height
        backend = resolve_backend(self.cfg.scan_backend)
        self.backend = "torch" if backend == "oracle" else backend
        # device= pins this detector to one card (batch mode); the plain
        # versions always run on the CPU
        if self.backend == "cuda":
            self.device = torch.device(device if device is not None
                                       else "cuda")
        else:
            self.device = torch.device("cpu")
        # device batch for luma is small: 1080p luma is ~2MB/frame
        self.device_batch = min(64, max(8, self.cfg.device_batch // 8))

    def _op(self, luma: torch.Tensor) -> torch.Tensor:
        return sad_ops.sad_op(
            luma, self.geom, sad_threshold=self.cfg.sad_threshold,
            block_size=self.cfg.block_size,
            clusters_needed=self.cfg.clusters_needed)[1]

    def scan_luma(self, luma: np.ndarray,
                  carry: np.ndarray | None = None) -> np.ndarray:
        """luma uint8 [N, H, W] (one chunk, decode order) -> motion [N].

        Without ``carry``, motion[0] is always False (no predecessor
        inside the chunk).  ``carry`` is the last ANALYZED frame of the
        chunk's previous cap-resumed sub-scan ([H, W]): motion[0] is then
        the real comparison against it, so splitting a chunk at the
        frame cap never changes decisions.
        """
        n = luma.shape[0]
        out = np.zeros((n,), bool)
        off = 0 if carry is None else 1
        nt = n + off  # virtual sequence: [carry?] + luma
        if nt < 2:
            return out
        db = self.device_batch
        # windows of db+1 frames overlapping by one: virtual frame v is
        # carry at v == 0 (when given) else luma[v - off]; the decision
        # for v lands at out[v - off].  On CUDA at most two windows are
        # in flight, so the pinned staging stays two windows large.
        in_flight = []

        def resolve(lo, motion, pending):
            wait(pending)
            m = motion.numpy()
            out[lo + 1 - off:lo + 1 - off + len(m)] = m

        for lo in range(0, nt - 1, db):
            hi = min(lo + db, nt - 1)
            if off and lo == 0:
                window = np.concatenate([carry[None], luma[:hi]])
            else:
                window = np.ascontiguousarray(luma[lo - off:hi + 1 - off])
            if len(in_flight) == 2:
                resolve(*in_flight.pop(0))
            in_flight.append((lo,) + stage_and_decide(window, self.device,
                                                      self._op))
        for item in in_flight:
            resolve(*item)
        return out
