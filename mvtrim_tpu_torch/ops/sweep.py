"""Multi-config sweep ops: score K detector configs over one decode.

The counterpart of ``mvtrim_tpu/ops/sweep.py``, with the configs as data:

* ``vote_sweep_op`` — vote grids scattered on the host at one MV
  threshold; K (vectors_needed, clusters_needed) pairs.
* ``sad_sweep_op``  — luma; K (SAD bound, clusters_needed) pairs over one
  block-SAD grid.
* ``mv_sweep_op``   — raw MV fields; K (magnitude bound, vectors_needed,
  clusters_needed) triples.

Each returns motion bool [B, K], K >= 1.  On a CUDA tensor every config launches a
kernel (the cluster-map kernel, or the fused raw-MV kernel) and the SAD
sweep launches the block-SAD kernel once; on a CPU tensor the plain
versions run.
"""

from __future__ import annotations

import torch

from ..core.types import GridGeometry
from . import cluster as cluster_ops
from . import mv_vote
from . import sad as sad_ops


def _configs(*cols) -> list[tuple[int, ...]]:
    return [tuple(int(v) for v in row) for row in zip(*cols)]


def vote_sweep_op(votes: torch.Tensor, geom: GridGeometry, vec_needs,
                  clusters_needs) -> torch.Tensor:
    """votes uint8 [B, gh, gw] x K (vec, clust) -> motion bool [B, K].

    Caveat for vec <= 0 columns: a zero vote grid cannot represent "no MV
    side data", so this op alone cannot reproduce the reference's
    unconditional ``!sd -> false`` (motion_scanner.cpp:219-221): zero
    votes satisfy ``>= 0`` and MV-less frames decide True.  Callers
    sweeping vec <= 0 mask MV-less frames themselves (tools/tune.py does,
    from scan_grids_multi's per-frame has_mv flags).
    """
    return torch.stack(
        [cluster_ops.cluster_map_op(votes, geom, vec, clust)[1]
         for vec, clust in _configs(vec_needs, clusters_needs)], dim=1)


def sad_sweep_op(luma: torch.Tensor, geom: GridGeometry, block_size: int,
                 bounds, clusters_needs) -> torch.Tensor:
    """luma uint8 [N, H, W] (unpadded) x K (bound, clust) -> motion bool
    [N-1, K]: row i decides luma[i+1] against luma[i] (row 0 is the
    predecessor, the SADDetector windowing).

    ``bounds`` are integer SAD-sum bounds (``sad.sad_threshold_sum``).  The
    block sums run once and every config runs the cluster rule over them
    at its bound.
    """
    if luma.device.type == "cuda":
        grid = sad_ops.sad_grid_op(luma, geom, block_size)
    elif luma.device.type == "cpu":
        sad_ops._check_luma(luma, geom, block_size)
        grid = sad_ops.sad_block_grid_plain(luma, block_size)
    else:
        raise RuntimeError(f"sad_sweep_op runs on cuda or cpu tensors, not "
                           f"{luma.device}")
    return torch.stack(
        [cluster_ops.cluster_map_op(grid, geom, bound, clust)[1]
         for bound, clust in _configs(bounds, clusters_needs)], dim=1)


def mv_sweep_op(mvs: torch.Tensor, counts: torch.Tensor, geom: GridGeometry,
                block_shift: int, bounds, vec_needs,
                clusters_needs) -> torch.Tensor:
    """mvs int16 [B, M, 4] + counts int32 [B] x K (bound, vec, clust) ->
    motion bool [B, K].

    ``bounds`` are integer magnitude bounds (``mv_vote.threshold_bound``),
    so the compare is exact; a frame with count 0 decides False in every
    column.
    """
    return torch.stack(
        [mv_vote.mv_cluster_op(mvs, counts, geom, bound, vec, clust,
                               block_shift)[1]
         for bound, vec, clust in _configs(bounds, vec_needs,
                                           clusters_needs)], dim=1)
