"""Fused raw-MV vote scatter and cluster count: the device op of the
``mv_raw`` payload and of the raw-MV tuning sweep.

The counterpart of ``mvtrim_tpu/ops/mv_vote.py``.  For each frame b, over
its MVs k < count[b] (rows of dst_x, dst_y, src_x, src_y):

* keep = mag >= bound and 0 <= dst_x >> shift < gw and
  y_min <= dst_y >> shift < y_max, with mag = dx^2 + dy^2 wrapped to int32
  as the reference's ``int`` does (|dx| reaches 65,535 for int16 fields)
  and the shifts arithmetic (floor for a negative dst, which drops the MV);
* every kept MV adds one vote to its cell (gy, gx);
* counts[b] = the vote-level cluster rule of ``ops/cluster.py`` over the
  votes at ``vectors_needed``, off-grid neighbours reading as vote 0;
* motion[b] = counts[b] >= max(1, clusters_needed) and count[b] > 0: a
  frame without MV side data decides False even at vectors_needed = 0
  (motion_scanner.cpp:219-221).

``bound`` (an integer: ``threshold_bound`` of the double threshold) and
``vectors_needed`` are runtime ints, so the raw-MV sweep launches the same
kernel per config.  ``mv_cluster_op`` is the one entry: on a CUDA tensor
it launches ``csrc/mv_cluster.cu``, which reads the int16 [B, M, 4]
payload as the host emits it and bounds its work by each frame's count; on
a CPU tensor it runs ``mv_cluster_counts_plain``.  Nothing falls back from
one to the other.
"""

from __future__ import annotations

import functools
import math

import torch

from ..core.types import GridGeometry
from . import _build
from . import cluster as cluster_ops


def threshold_bound(threshold_sq: float) -> int:
    """Integer bound b with (mag < threshold_sq) == (mag < b) for integer
    mag (b = ceil of the double threshold)."""
    return int(math.ceil(threshold_sq))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits, still as int64."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def keep_mask(mvs: torch.Tensor, counts: torch.Tensor, geom: GridGeometry,
              bound: int, block_shift: int):
    """The keep rule over mvs int16 [B, M, 4] + counts int32 [B]: (keep
    bool [B, n], gx, gy int64 [B, n]) over the first n = max(count) MVs of
    each row (clamped to 0..M); the rest fail ``k < count`` in every frame.
    The magnitude is formed in int64 and wrapped to int32; the shifts are
    arithmetic on the widened fields."""
    b = mvs.shape[0]
    m = int(counts.clamp(0, mvs.shape[1]).max()) if b else 0
    f = mvs[:, :m].to(torch.int64)
    dx = f[..., 0] - f[..., 2]
    dy = f[..., 1] - f[..., 3]
    mag = _wrap_int32(dx * dx + dy * dy)
    gx = f[..., 0] >> block_shift
    gy = f[..., 1] >> block_shift
    idx = torch.arange(m, device=mvs.device)
    keep = ((idx[None, :] < counts[:, None].to(torch.int64))
            & (mag >= bound) & (gx >= 0) & (gx < geom.gw)
            & (gy >= geom.y_min) & (gy < geom.y_max))
    return keep, gx, gy


def mv_votes_plain(mvs: torch.Tensor, counts: torch.Tensor,
                   geom: GridGeometry, bound: int,
                   block_shift: int) -> torch.Tensor:
    """Plain PyTorch vote scatter: mvs int16 [B, M, 4] + counts int32 [B]
    -> int32 votes [B, gh, gw], no saturation: one vote a kept MV
    (``keep_mask``) in its cell."""
    b = mvs.shape[0]
    keep, gx, gy = keep_mask(mvs, counts, geom, bound, block_shift)
    frame = torch.arange(b, device=mvs.device)[:, None]
    flat = ((frame * geom.gh + gy) * geom.gw + gx)[keep]
    votes = torch.zeros((b * geom.gh * geom.gw,), dtype=torch.int32,
                        device=mvs.device)
    votes.index_put_((flat,), torch.ones_like(flat, dtype=torch.int32),
                     accumulate=True)
    return votes.reshape(b, geom.gh, geom.gw)


def mv_cluster_counts_plain(mvs: torch.Tensor, counts: torch.Tensor,
                            geom: GridGeometry, bound: int,
                            vectors_needed: int,
                            block_shift: int) -> torch.Tensor:
    """Plain PyTorch cluster counts of the raw-MV payload: mvs int16
    [B, M, 4] + counts int32 [B] -> int32 [B] (``mv_votes_plain``, then
    the vote-level rule at ``vectors_needed``)."""
    votes = mv_votes_plain(mvs, counts, geom, bound, block_shift)
    return cluster_ops.cluster_map_counts_plain(votes, geom, vectors_needed)


def _check_mvs(mvs: torch.Tensor, counts: torch.Tensor | None) -> None:
    """mvs int16 [B, M, 4], contiguous, 8-byte aligned, and counts int32
    [B] on its device (None: a function of the fields alone)."""
    if mvs.dtype != torch.int16:
        raise TypeError(f"mvs must be int16, got {mvs.dtype}")
    if mvs.dim() != 3 or mvs.shape[2] != 4:
        raise ValueError(f"mvs must be [B, M, 4], got {tuple(mvs.shape)}")
    if counts is not None:
        if counts.dtype != torch.int32 or \
                tuple(counts.shape) != mvs.shape[:1]:
            raise ValueError(
                f"counts must be int32 [{mvs.shape[0]}], got {counts.dtype} "
                f"{tuple(counts.shape)}")
        if counts.device != mvs.device:
            raise ValueError(
                f"counts on {counts.device}, mvs on {mvs.device}")
        if not counts.is_contiguous():
            raise ValueError("counts must be contiguous")
    if not mvs.is_contiguous():
        raise ValueError("mvs must be contiguous")
    if mvs.data_ptr() % 8:
        raise ValueError("mvs must start on an 8-byte boundary (one load "
                         "an MV)")


@functools.lru_cache(maxsize=256)
def _scratch_cells(batch: int, geom: GridGeometry, device_index: int,
                   force_global: bool) -> int:
    """int32 cells of global histogram scratch a launch needs, 0 where the
    kernel keeps its histograms in shared memory (the kernel's own answer,
    from its shared-memory layout and the card's opt-in limit)."""
    with torch.cuda.device(device_index):
        cells = _build.load_library().mvt_mv_cluster_scratch(
            batch, geom.gh, geom.gw, geom.y_min, geom.y_max,
            int(force_global))
    if cells < 0:
        raise RuntimeError(f"scratch query failed: CUDA error {-cells}")
    return cells


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def uses_global_histogram(geom: GridGeometry, device: torch.device) -> bool:
    """True when a frame's int32 vote histogram (with the kernel's words
    and warp sums) does not fit the shared memory of one block."""
    return _scratch_cells(1, geom, _device_index(device), False) > 0


def _launch(mvs: torch.Tensor, counts: torch.Tensor, geom: GridGeometry,
            bound: int, thr: int, need: int, block_shift: int,
            force_global: bool):
    b, m, _ = mvs.shape
    dev = mvs.device
    got, motion = cluster_ops.outputs(mvs, b)
    cells = _scratch_cells(b, geom, dev.index, force_global)
    scratch = torch.empty((cells,), dtype=torch.int32, device=dev) \
        if cells else None
    _build.launch("mvt_mv_cluster_counts", mv_cluster_op, dev,
                  mvs.data_ptr(), counts.data_ptr(), b, m, geom.gh, geom.gw,
                  geom.y_min, geom.y_max, bound, thr, need, block_shift,
                  None if scratch is None else scratch.data_ptr(), cells,
                  got.data_ptr(), motion.data_ptr())
    return got, motion


def mv_cluster_op(mvs: torch.Tensor, counts: torch.Tensor,
                  geom: GridGeometry, bound: int, vectors_needed: int,
                  clusters_needed: int, block_shift: int, *,
                  global_histogram: bool = False):
    """mvs int16 [B, M, 4] + counts int32 [B] (non-negative) -> (counts
    int32 [B], motion bool [B]); ``bound`` and ``vectors_needed`` are
    runtime ints.

    A CUDA tensor goes to the CUDA kernel (``mv_cluster_op.launches``
    counts those launches), with its histograms in shared memory unless
    ``global_histogram`` asks for the global-scratch variant (without it,
    the kernel takes that variant only where a grid does not fit); a CPU
    tensor goes to ``mv_cluster_counts_plain``; any other device raises.
    """
    _check_mvs(mvs, counts)
    # the kernel compares in int32 (votes) and int64 (magnitudes)
    thr = max(-(1 << 31), min(int(vectors_needed), (1 << 31) - 1))
    bound = max(-(1 << 63), min(int(bound), (1 << 63) - 1))
    need = max(1, clusters_needed)
    if mvs.device.type == "cuda":
        return _launch(mvs, counts, geom, bound, thr, need, block_shift,
                       bool(global_histogram))
    if mvs.device.type == "cpu":
        out = mv_cluster_counts_plain(mvs, counts, geom, bound, thr,
                                      block_shift)
        return out, (out >= need) & (counts > 0)
    raise RuntimeError(
        f"mv_cluster_op runs on cuda or cpu tensors, not {mvs.device}")


mv_cluster_op.launches = 0

