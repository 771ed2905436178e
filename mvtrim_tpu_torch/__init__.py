"""motion-estimated-video-trimmer on PyTorch and CUDA.

The port of ``mvtrim_tpu`` to an NVIDIA H100: the MV scan path over the
bits, words and grids payloads (activity masks or vote grids -> cluster
kernel -> segmentation -> lossless cut) and the pixel-domain SAD scan of
MV-less video (luma -> block-SAD and cluster-map kernels), through the
same entry points (``python -m mvtrim_tpu_torch <in> <out>``, batch and
watch mode).

The framework-free layers are shared with ``mvtrim_tpu``, not copied:
``core`` (config, types, NumPy oracle), ``io.native`` (the C++ host
decode library), ``cut.executor`` and ``utils``.  None of them imports
jax; the value types, ``oracle`` and ``native`` are re-exported here.
What does import jax there has a twin here, at the same relative path:

  ops/       the word-domain and vote-level cluster ops and the block
             SAD op: hand-written CUDA kernels (csrc/*.cu, built at first
             use) + plain PyTorch
  models/    MVClusterDetector over the bits/words/grids payloads and
             SADDetector over luma
  pipeline/  single-video pipeline (probe -> scan -> segment -> cut)
  batch/     multi-video scheduler and watch mode
"""

from mvtrim_tpu.core import Config, GridGeometry, ScanTask, TimeSegment
from mvtrim_tpu.core import oracle
from mvtrim_tpu.io import native

__all__ = ["Config", "TimeSegment", "ScanTask", "GridGeometry", "oracle",
           "native"]
