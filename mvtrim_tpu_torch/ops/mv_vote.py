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

import ctypes
import functools
import math

import numpy as np
import torch

from ..core.types import GridGeometry
from . import cluster as cluster_ops


def threshold_bound(threshold_sq: float) -> int:
    """Integer bound b with (mag < threshold_sq) == (mag < b) for integer
    mag (b = ceil of the double threshold)."""
    return int(math.ceil(threshold_sq))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits, still as int64."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def mv_votes_plain(mvs: torch.Tensor, counts: torch.Tensor,
                   geom: GridGeometry, bound: int,
                   block_shift: int) -> torch.Tensor:
    """Plain PyTorch vote scatter: mvs int16 [B, M, 4] + counts int32 [B]
    -> int32 votes [B, gh, gw], no saturation.

    Only the first max(count) MVs of each row are read: the rest fail
    ``k < count`` in every frame.  The magnitude is formed in int64 and
    wrapped to int32; the shifts are arithmetic on the widened fields.
    """
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


def _check_mvs(mvs: torch.Tensor, counts: torch.Tensor) -> None:
    if mvs.dtype != torch.int16:
        raise TypeError(f"mvs must be int16, got {mvs.dtype}")
    if mvs.dim() != 3 or mvs.shape[2] != 4:
        raise ValueError(f"mvs must be [B, M, 4], got {tuple(mvs.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != mvs.shape[:1]:
        raise ValueError(
            f"counts must be int32 [{mvs.shape[0]}], got {counts.dtype} "
            f"{tuple(counts.shape)}")
    if counts.device != mvs.device:
        raise ValueError(f"counts on {counts.device}, mvs on {mvs.device}")
    if not (mvs.is_contiguous() and counts.is_contiguous()):
        raise ValueError("mvs and counts must be contiguous")
    if mvs.data_ptr() % 8:
        raise ValueError("mvs must start on an 8-byte boundary (one load "
                         "an MV)")


@functools.lru_cache(maxsize=None)
def shared_memory_limit(device_index: int) -> int:
    """Bytes of shared memory one block of the card may opt in to."""
    from ._build import load_library

    with torch.cuda.device(device_index):
        limit = load_library().mvt_max_shared_per_block()
    if limit < 0:
        raise RuntimeError(f"shared-memory query failed: CUDA error {-limit}")
    return limit


def uses_global_histogram(geom: GridGeometry, device: torch.device) -> bool:
    """True when a frame's int32 vote histogram (and the kernel's eight
    warp sums) does not fit the shared memory of one block."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return (geom.gh * geom.gw + 8) * 4 > shared_memory_limit(index)


def _launch(mvs: torch.Tensor, counts: torch.Tensor, geom: GridGeometry,
            bound: int, thr: int, need: int, block_shift: int,
            global_histogram: bool):
    from ._build import load_library

    lib = load_library()
    b, m, _ = mvs.shape
    dev = mvs.device
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    motion = torch.empty((b,), dtype=torch.bool, device=dev)
    scratch, blocks = None, 0
    if global_histogram and b:
        # one histogram per CTA, two CTAs per SM striding over the frames
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(b, 2 * sms)
        scratch = torch.empty((blocks * geom.gh * geom.gw,),
                              dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mvt_mv_cluster_counts(
            mvs.data_ptr(), counts.data_ptr(), b, m, geom.gh, geom.gw,
            geom.y_min, geom.y_max, bound, thr, need, block_shift,
            None if scratch is None else scratch.data_ptr(), blocks,
            out.data_ptr(), motion.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"mv_cluster kernel launch failed: CUDA error {err}")
    return out, motion


def mv_cluster_op(mvs: torch.Tensor, counts: torch.Tensor,
                  geom: GridGeometry, bound: int, vectors_needed: int,
                  clusters_needed: int, block_shift: int, *,
                  global_histogram: bool | None = None):
    """mvs int16 [B, M, 4] + counts int32 [B] (non-negative) -> (counts
    int32 [B], motion bool [B]); ``bound`` and ``vectors_needed`` are
    runtime ints.

    A CUDA tensor goes to the CUDA kernel (``mv_cluster_op.launches``
    counts those launches), with its histograms in shared memory unless
    ``global_histogram`` asks for the global-scratch variant (the default
    takes it only where a grid does not fit); a CPU tensor goes to
    ``mv_cluster_counts_plain``; any other device raises.
    """
    _check_mvs(mvs, counts)
    # the kernel compares in int32 (votes) and int64 (magnitudes)
    thr = max(-(1 << 31), min(int(vectors_needed), (1 << 31) - 1))
    bound = max(-(1 << 63), min(int(bound), (1 << 63) - 1))
    need = max(1, clusters_needed)
    if mvs.device.type == "cuda":
        if global_histogram is None:
            global_histogram = uses_global_histogram(geom, mvs.device)
        out, motion = _launch(mvs, counts, geom, bound, thr, need,
                              block_shift, global_histogram)
        with cluster_ops._launch_lock:
            mv_cluster_op.launches += 1
        return out, motion
    if mvs.device.type == "cpu":
        out = mv_cluster_counts_plain(mvs, counts, geom, bound, thr,
                                      block_shift)
        return out, (out >= need) & (counts > 0)
    raise RuntimeError(
        f"mv_cluster_op runs on cuda or cpu tensors, not {mvs.device}")


mv_cluster_op.launches = 0


def host_expected_clusters(dst_x, dst_y, src_x, src_y, counts,
                           geom: GridGeometry, *, threshold_sq: float,
                           block_shift: int, vectors_needed: int):
    """Vectorized NumPy restatement of the keep mask + vote scatter +
    cluster count, for audits.

    Returns (kept_counts int64 [B], cluster_counts int64 [B]).  Kept from
    the JAX package as it is: its magnitude is int64, not wrapped, so it
    agrees with the kernels only where no |d|^2 sum passes 2^31.
    """
    from ..core.oracle import count_clusters_batch

    dst_x = np.asarray(dst_x)
    dst_y = np.asarray(dst_y)
    b, m = dst_x.shape
    bound = threshold_bound(threshold_sq)
    dx = dst_x.astype(np.int64) - np.asarray(src_x)
    dy = dst_y.astype(np.int64) - np.asarray(src_y)
    mag = dx * dx + dy * dy
    gx = dst_x >> block_shift
    gy = dst_y >> block_shift
    idx_ok = np.arange(m)[None, :] < np.asarray(counts)[:, None]
    keep = (idx_ok & (mag >= bound) & (gx >= 0) & (gx < geom.gw)
            & (gy >= geom.y_min) & (gy < geom.y_max))
    kept_counts = keep.sum(axis=1).astype(np.int64)
    flat = (np.arange(b)[:, None] * (geom.gh * geom.gw)
            + gy * geom.gw + gx)
    votes = np.bincount(flat[keep].ravel(),
                        minlength=b * geom.gh * geom.gw
                        ).reshape(b, geom.gh, geom.gw)
    votes = np.minimum(votes, 255)  # saturation is decision-preserving
    clusters = count_clusters_batch(
        votes, vectors_needed=vectors_needed,
        y_min=geom.y_min, y_max=geom.y_max)
    return kept_counts, clusters.astype(np.int64)


def pad_mvs(mv_list, m: int):
    """Host helper: list of [n_i, 4] int arrays -> ([B, M] x4 int32, counts).

    Rows are (dst_x, dst_y, src_x, src_y).  Frames with more than M MVs are
    truncated with a flag so callers can re-run them through the oracle.
    """
    b = len(mv_list)
    dst_x = np.zeros((b, m), np.int32)
    dst_y = np.zeros((b, m), np.int32)
    src_x = np.zeros((b, m), np.int32)
    src_y = np.zeros((b, m), np.int32)
    counts = np.zeros((b,), np.int32)
    overflow = np.zeros((b,), bool)
    for i, mvs in enumerate(mv_list):
        mvs = np.asarray(mvs, np.int32).reshape(-1, 4)
        n = mvs.shape[0]
        if n > m:
            overflow[i] = True
            n = m
        counts[i] = n
        dst_x[i, :n] = mvs[:n, 0]
        dst_y[i, :n] = mvs[:n, 1]
        src_x[i, :n] = mvs[:n, 2]
        src_y[i, :n] = mvs[:n, 3]
    return dst_x, dst_y, src_x, src_y, counts, overflow
