"""Cluster counts: the device ops of the MV scan paths.

Two halves of ``mvtrim_tpu/ops/cluster.py``, each one op with a
hand-written CUDA kernel and a plain PyTorch version of the same math:

* word domain (``cluster_words_op``, ``csrc/word_cluster.cu``): the bits
  and words payloads.  Each int32 word holds 32 grid cells of one row
  (bit k of word c is cell x = 32c + k).  A cell counts when it is
  active, has an active 4-neighbour and lies in the centre window.
* vote level (``cluster_map_op``, ``csrc/cluster_map.cu``): the grids
  payload, and the second half of the SAD path.  A cell of a uint8 or
  int32 grid counts when it and one of its 4-neighbours reach a runtime
  threshold and it lies in the centre window; off-grid neighbours read as
  vote 0, compared with the threshold like any other cell.

The centre window is x in [1, gw-2], y in [y_min, y_max); a frame has
motion when its count reaches max(1, CLUSTERS_NEEDED).  On a CUDA tensor
each op launches its kernel, on a CPU tensor it runs the plain version.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import GridGeometry


def word_geometry(geom: GridGeometry) -> tuple[int, int, int]:
    """(gww, used, L): int32 words per row, used words per frame, and
    lane-padded flat length for the word-domain kernel (rows re-packed to
    4-byte multiples so every word covers 32 consecutive x cells)."""
    gww = (geom.gw + 31) // 32
    used = geom.gh * gww
    lanes = ((used + 127) // 128) * 128
    return gww, used, lanes


def repack_bits_words(bits: "np.ndarray", geom: GridGeometry):
    """Host repack: mvt_scan_bits [N, gh, gwb] -> int32 words [N, used].

    Rows are padded to 4-byte multiples and viewed little-endian, so word
    w of a row holds cells x = 32w..32w+31 in bit order — the byte layout
    generalized to 32-cell lanes.
    """
    n, gh, gwb = bits.shape
    gww, used, _ = word_geometry(geom)
    rows = np.zeros((n, gh, gww * 4), np.uint8)
    rows[:, :, :gwb] = bits
    return rows.reshape(n, gh * gww * 4).view("<i4")


def center_word_mask(geom: GridGeometry) -> np.ndarray:
    """int32 [used]: the centre-window bits of each word, by the closed
    form the CUDA kernel evaluates per word (``center_bits``): bits k of
    word c with 1 <= 32c + k <= gw - 2, in rows y_min <= y < y_max."""
    gww, used, _ = word_geometry(geom)
    x0 = 32 * np.arange(gww, dtype=np.int64)
    k_lo = np.maximum(0, 1 - x0)
    k_hi = np.minimum(31, geom.gw - 2 - x0)
    upto_hi = (np.int64(1) << (np.maximum(k_hi, -1) + 1)) - 1
    row = np.where(k_hi >= k_lo, upto_hi & ~((np.int64(1) << k_lo) - 1), 0)
    mask = np.zeros((geom.gh, gww), np.uint32)
    mask[max(geom.y_min, 0):geom.y_max] = row.astype(np.uint32)
    return mask.reshape(used).view(np.int32)


@functools.lru_cache(maxsize=64)
def _center_int64(geom: GridGeometry, device: torch.device) -> torch.Tensor:
    """center_word_mask as unsigned values in int64 [gh, gww] on device."""
    mask = center_word_mask(geom).view(np.uint32).astype(np.int64)
    return torch.from_numpy(mask).reshape(geom.gh, -1).to(device)


def word_cluster_counts_plain(words: torch.Tensor,
                              geom: GridGeometry) -> torch.Tensor:
    """Plain PyTorch cluster counts: int32 words [B, used] -> int32 [B].

    The math of the JAX ``word_cluster_counts`` with zero-filled
    neighbours at row and frame edges.  Words are widened to int64 and
    masked to their unsigned 32-bit value, so every >> is logical.
    """
    gww, used, _ = word_geometry(geom)
    b = words.shape[0]
    w = (words.to(torch.int64) & 0xFFFFFFFF).reshape(b, geom.gh, gww)
    zc = w.new_zeros((b, geom.gh, 1))
    zr = w.new_zeros((b, 1, gww))
    prev = torch.cat([zc, w[:, :, :-1]], dim=2)
    nxt = torch.cat([w[:, :, 1:], zc], dim=2)
    up = torch.cat([zr, w[:, :-1]], dim=1)
    down = torch.cat([w[:, 1:], zr], dim=1)
    left = ((w << 1) & 0xFFFFFFFF) | (prev >> 31)
    right = (w >> 1) | ((nxt & 1) << 31)
    cl = w & (left | right | up | down) & _center_int64(geom, w.device)
    # SWAR popcount of each 32-bit value
    v = cl - ((cl >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return v.sum(dim=(1, 2)).to(torch.int32)


def _check_words(words: torch.Tensor, geom: GridGeometry) -> None:
    used = word_geometry(geom)[1]
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {words.dtype}")
    if words.dim() != 2 or words.shape[1] != used:
        raise ValueError(
            f"words must be [B, {used}] for a {geom.gw}x{geom.gh} grid, "
            f"got {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")


def _launch(words: torch.Tensor, geom: GridGeometry, need: int):
    from ._build import load_library

    lib = load_library()
    gww, _, _ = word_geometry(geom)
    b = words.shape[0]
    counts = torch.empty((b,), dtype=torch.int32, device=words.device)
    motion = torch.empty((b,), dtype=torch.bool, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.mvt_word_cluster_counts(
            words.data_ptr(), b, geom.gh, gww, geom.gw, geom.y_min,
            geom.y_max, need, counts.data_ptr(), motion.data_ptr(),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"word_cluster kernel launch failed: CUDA error {err}")
    return counts, motion


_launch_lock = threading.Lock()


def cluster_words_op(words: torch.Tensor, geom: GridGeometry,
                     clusters_needed: int):
    """words int32 [B, used] -> (counts int32 [B], motion bool [B]).

    A CUDA tensor goes to the CUDA kernel (``cluster_words_op.launches``
    counts those launches), a CPU tensor to ``word_cluster_counts_plain``;
    any other device raises.
    """
    _check_words(words, geom)
    need = max(1, clusters_needed)
    if words.device.type == "cuda":
        counts, motion = _launch(words, geom, need)
        with _launch_lock:
            cluster_words_op.launches += 1
        return counts, motion
    if words.device.type == "cpu":
        counts = word_cluster_counts_plain(words, geom)
        return counts, counts >= need
    raise RuntimeError(
        f"cluster_words_op runs on cuda or cpu tensors, not {words.device}")


cluster_words_op.launches = 0


# --- vote level: the grids payload and the SAD grid ---

_VOTE_DTYPES = (torch.uint8, torch.int32)


def cluster_map_counts_plain(votes: torch.Tensor, geom: GridGeometry,
                             threshold: int) -> torch.Tensor:
    """Plain PyTorch cluster counts: votes [B, gh, gw] (uint8 or int32)
    -> int32 [B], with a runtime ``threshold``.

    The math of the JAX ``cluster_counts_traced``: a centre cell counts
    when min(v, max of its 4 neighbours) >= threshold, neighbours off the
    grid reading as vote 0.
    """
    v = votes.to(torch.int32)
    p = F.pad(v, (1, 1, 1, 1))  # zero votes around the grid
    nmax = torch.maximum(
        torch.maximum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]),
        torch.maximum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]))
    hit = torch.minimum(v, nmax) >= threshold
    center = torch.zeros((geom.gh, geom.gw), dtype=torch.bool,
                         device=v.device)
    center[max(geom.y_min, 0):geom.y_max, 1:max(1, geom.gw - 1)] = True
    return (hit & center).sum(dim=(1, 2), dtype=torch.int32)


def _check_votes(votes: torch.Tensor, geom: GridGeometry) -> None:
    if votes.dtype not in _VOTE_DTYPES:
        raise TypeError(f"votes must be uint8 or int32, got {votes.dtype}")
    if votes.dim() != 3 or tuple(votes.shape[1:]) != (geom.gh, geom.gw):
        raise ValueError(
            f"votes must be [B, {geom.gh}, {geom.gw}], got "
            f"{tuple(votes.shape)}")
    if not votes.is_contiguous():
        raise ValueError("votes must be contiguous")


def _launch_map(votes: torch.Tensor, geom: GridGeometry, threshold: int,
                need: int):
    from ._build import load_library

    lib = load_library()
    b = votes.shape[0]
    counts = torch.empty((b,), dtype=torch.int32, device=votes.device)
    motion = torch.empty((b,), dtype=torch.bool, device=votes.device)
    with torch.cuda.device(votes.device):
        stream = torch.cuda.current_stream(votes.device).cuda_stream
        err = lib.mvt_cluster_map_counts(
            votes.data_ptr(), int(votes.dtype == torch.int32), b, geom.gh,
            geom.gw, geom.y_min, geom.y_max, threshold, need,
            counts.data_ptr(), motion.data_ptr(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"cluster_map kernel launch failed: CUDA error {err}")
    return counts, motion


def cluster_map_op(votes: torch.Tensor, geom: GridGeometry, threshold: int,
                   clusters_needed: int):
    """votes [B, gh, gw] uint8 or int32 -> (counts int32 [B], motion bool
    [B]), a cell active at ``threshold`` (a runtime int).

    A CUDA tensor goes to the CUDA kernel (``cluster_map_op.launches``
    counts those launches), a CPU tensor to ``cluster_map_counts_plain``;
    any other device raises.
    """
    _check_votes(votes, geom)
    # the kernel compares in int32
    threshold = max(-(1 << 31), min(int(threshold), (1 << 31) - 1))
    need = max(1, clusters_needed)
    if votes.device.type == "cuda":
        counts, motion = _launch_map(votes, geom, threshold, need)
        with _launch_lock:
            cluster_map_op.launches += 1
        return counts, motion
    if votes.device.type == "cpu":
        counts = cluster_map_counts_plain(votes, geom, threshold)
        return counts, counts >= need
    raise RuntimeError(
        f"cluster_map_op runs on cuda or cpu tensors, not {votes.device}")


cluster_map_op.launches = 0
