"""Block SAD: the device op of the pixel-domain (MV-less) scan path.

The counterpart of ``mvtrim_tpu/ops/sad.py``.  For each pair of
consecutive analyzed luma frames, every ``block_size`` x ``block_size``
block gets the sum of absolute differences; a block is active when that
sum reaches ``sad_threshold_sum`` (a mean absolute difference per pixel
turned into an integer bound), and the active blocks run through the
vote-level cluster rule of ``ops/cluster.py``.

``sad_op`` is the one entry: on a CUDA tensor it launches the block-SAD
kernel (``csrc/sad_block.cu``, through ``sad_grid_op``, which the SAD
sweep calls too) and then the cluster-map kernel
(``csrc/cluster_map.cu``) on the int32 grid; on a CPU tensor it runs
``sad_block_grid_plain`` and ``cluster_map_counts_plain``.  Nothing falls
back from one to the other.  Luma is taken unpadded: pixels of a partial
edge block that lie outside the frame count as zero difference, which is
what the JAX package's zero padding (``pad_luma``) gives.  Every sum is an
exact integer.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import GridGeometry
from . import cluster as cluster_ops


def sad_threshold_sum(sad_threshold: float, block_size: int) -> int:
    """Active iff block SAD sum >= ceil(threshold * block_area).

    ``sad_threshold`` is a mean absolute difference per pixel; comparing
    against the integer SAD sum keeps the kernels in integers.
    """
    return int(math.ceil(sad_threshold * block_size * block_size))


def pad_luma(luma: np.ndarray, geom: GridGeometry,
             block_size: int) -> np.ndarray:
    """Zero-pad [N, H, W] luma to the JAX package's block-aligned padded
    grid extents (its SAD ops take only such input; the port's do not)."""
    n, h, w = luma.shape
    h_p = geom.padded_gh * block_size
    w_p = geom.padded_gw * block_size
    out = np.zeros((n, h_p, w_p), np.uint8)
    out[:, :h, :w] = luma
    return out


def sad_block_grid_plain(luma: torch.Tensor,
                         block_size: int) -> torch.Tensor:
    """Plain PyTorch block SAD: luma uint8 [1+B, H, W] (frame 0 the
    carry) -> int32 [B, ceil(H/bs), ceil(W/bs)], block (by, bx) of frame
    b summing |luma[b+1] - luma[b]| over its in-frame pixels."""
    _, h, w = luma.shape
    gh, gw = -(-h // block_size), -(-w // block_size)
    x = luma.to(torch.int16)
    diff = (x[1:] - x[:-1]).abs_()
    diff = F.pad(diff, (0, gw * block_size - w, 0, gh * block_size - h))
    b = diff.shape[0]
    return diff.reshape(b, gh, block_size, gw, block_size).sum(
        dim=(2, 4), dtype=torch.int32)


def _check_luma(luma: torch.Tensor, geom: GridGeometry,
                block_size: int) -> None:
    if luma.dtype != torch.uint8:
        raise TypeError(f"luma must be uint8, got {luma.dtype}")
    if luma.dim() != 3 or luma.shape[0] < 1:
        raise ValueError(
            f"luma must be [1+B, H, W] with frame 0 the carry, got "
            f"{tuple(luma.shape)}")
    _, h, w = luma.shape
    if (-(-h // block_size), -(-w // block_size)) != (geom.gh, geom.gw):
        raise ValueError(
            f"a {w}x{h} frame in {block_size}-pixel blocks is not the "
            f"{geom.gw}x{geom.gh} grid of its geometry")
    if not luma.is_contiguous():
        raise ValueError("luma must be contiguous")


def _vector_width(luma: torch.Tensor, block_size: int) -> int:
    """Bytes per load for the kernel: the widest of 16, 4, 1 that divides
    the row pitch, the block size and the base address, with block/vec a
    power of two no larger than a warp."""
    w = luma.shape[2]
    for vec in (16, 4, 1):
        tpb = block_size // vec
        if (w % vec == 0 and block_size % vec == 0
                and luma.data_ptr() % vec == 0
                and 1 <= tpb <= 32 and tpb & (tpb - 1) == 0):
            return vec
    raise ValueError(
        f"the SAD kernel takes no {block_size}-pixel blocks on {w}-byte "
        f"rows (block / load width must be a power of two up to 32)")


def _launch_grid(luma: torch.Tensor, geom: GridGeometry,
                 block_size: int) -> torch.Tensor:
    from ._build import load_library

    lib = load_library()
    b = luma.shape[0] - 1
    _, h, w = luma.shape
    vec = _vector_width(luma, block_size)
    grid = torch.empty((b, geom.gh, geom.gw), dtype=torch.int32,
                       device=luma.device)
    with torch.cuda.device(luma.device):
        stream = torch.cuda.current_stream(luma.device).cuda_stream
        err = lib.mvt_sad_block_grid(
            luma.data_ptr(), b, h, w, block_size, geom.gh, geom.gw, vec,
            grid.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sad_block kernel launch failed: CUDA error {err}")
    return grid


def sad_grid_op(luma: torch.Tensor, geom: GridGeometry,
                block_size: int) -> torch.Tensor:
    """luma uint8 [1+B, H, W] on the card -> int32 block-SAD grid [B, gh,
    gw] from the block-SAD kernel (``sad_grid_op.launches`` counts its
    launches)."""
    _check_luma(luma, geom, block_size)
    grid = _launch_grid(luma, geom, block_size)
    with cluster_ops._launch_lock:
        sad_grid_op.launches += 1
    return grid


sad_grid_op.launches = 0


def sad_op(luma: torch.Tensor, geom: GridGeometry, *, sad_threshold: float,
           block_size: int, clusters_needed: int):
    """luma uint8 [1+B, H, W] (frame 0 = carry, unpadded) -> (counts
    int32 [B], motion bool [B]).

    A CUDA tensor goes to the block-SAD kernel (``sad_grid_op``) and then
    the cluster-map kernel; a CPU tensor to the two plain versions; any
    other device raises.
    """
    _check_luma(luma, geom, block_size)
    bound = sad_threshold_sum(sad_threshold, block_size)
    if luma.device.type == "cuda":
        grid = sad_grid_op(luma, geom, block_size)
        return cluster_ops.cluster_map_op(grid, geom, bound, clusters_needed)
    if luma.device.type == "cpu":
        grid = sad_block_grid_plain(luma, block_size)
        return cluster_ops.cluster_map_op(grid, geom, bound, clusters_needed)
    raise RuntimeError(f"sad_op runs on cuda or cpu tensors, not {luma.device}")
