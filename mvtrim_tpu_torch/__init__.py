"""motion-estimated-video-trimmer on PyTorch and CUDA.

The port of ``mvtrim_tpu`` to an NVIDIA H100: the MV scan path over the
bits, words, grids and raw-MV payloads (activity masks, vote grids or the
codec's motion vectors -> cluster kernels -> segmentation -> lossless
cut), the pixel-domain SAD scan of MV-less video (luma -> block-SAD and
cluster-map kernels), the sharded archive scan and the tuning sweeps,
through the same entry points (``python -m mvtrim_tpu_torch <in> <out>``,
batch, watch and archive mode, and ``python -m mvtrim_tpu_torch.tools.*``).

The package imports nothing of ``mvtrim_tpu``.  Its framework-free layers
are copies of that package's, at the same relative paths, so one
environment configures both alike:

  core/      config knobs (the reference's env names), value types, the
             NumPy oracle
  io/        ctypes bridge to the repo's C++ host decode library (native/)
  cut/       lossless cut executors and the cut job queue
  utils/     logging, phase timing, cgroup-aware CPU limits

What runs on the device is the port's own:

  ops/       the word-domain and vote-level cluster ops, the fused raw-MV
             vote-and-cluster op, the block SAD op and the sweep and
             segmentation ops: hand-written CUDA kernels (csrc/*.cu, built
             at first use) + plain PyTorch
  models/    MVClusterDetector over the MV payloads and SADDetector over
             luma
  pipeline/  single-video pipeline (probe -> scan -> segment -> cut)
  batch/     multi-video scheduler and watch mode
  parallel/  device mesh, sharded scan steps, the archive scan with
             chunk-granular checkpoints, multi-process runs (gloo)
  tools/     tune (detector configs swept over one decode), doctor,
             device_probe, extract_mvs, motion_scalar, heatmap
"""

from .core import Config, GridGeometry, ScanTask, TimeSegment
from .core import oracle
from .io import native

__all__ = ["Config", "TimeSegment", "ScanTask", "GridGeometry", "oracle",
           "native"]
