"""Cluster counts: the device ops of the MV scan paths.

Two halves of ``mvtrim_tpu/ops/cluster.py``, each with a hand-written
CUDA kernel and a plain PyTorch version of the same math:

* word domain (``cluster_bits_op`` and ``cluster_words_op``, one kernel,
  ``csrc/word_cluster.cu``): the bits payload, uint8 [B, gh, ceil(gw/8)]
  as the native scanner emits it, and the words payload, int32 [B, gh *
  gww].  The kernel reads either as rows of bytes at their own pitch:
  word c of a row is bytes 4c..4c+3, little-endian, so bit k of word c is
  cell x = 32c + k (byte j of a bits row is byte j of a words row).  A
  cell counts when it is active, has an active 4-neighbour and lies in
  the centre window.  ``cluster_staged_op`` runs the same kernel on a
  batch staged in pinned host memory, with both copies and the event in
  the same native call (the detector's path on the card).
* vote level (``cluster_map_op``, ``csrc/cluster_map.cu``): the grids
  payload, and the second half of the SAD path.  A cell of a uint8 or
  int32 grid counts when it and one of its 4-neighbours reach a runtime
  threshold and it lies in the centre window; off-grid neighbours read as
  vote 0, compared with the threshold like any other cell.  The kernel
  packs ``votes >= threshold`` into the word domain's words and runs the
  word rule on them, off-grid rows reading as all ones at a threshold
  <= 0 (``csrc/cluster_words.cuh``).

The centre window is x in [1, gw-2], y in [y_min, y_max); a frame has
motion when its count reaches max(1, CLUSTERS_NEEDED).  On a CUDA tensor
each op launches its kernel, on a CPU tensor it runs the plain version.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import GridGeometry
from . import _build


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


def bits_to_words(bits: torch.Tensor, geom: GridGeometry) -> torch.Tensor:
    """``repack_bits_words`` in torch, on the bits' device: uint8 [B, gh,
    ceil(gw/8)] -> int32 words [B, used], each row padded with zero bytes
    to 4 * gww and read as little-endian int32 words."""
    gww, used, _ = word_geometry(geom)
    rows = F.pad(bits, (0, 4 * gww - bits.shape[2]))
    return rows.reshape(bits.shape[0], 4 * used).view(torch.int32)


def bits_cluster_counts_plain(bits: torch.Tensor,
                              geom: GridGeometry) -> torch.Tensor:
    """Plain PyTorch cluster counts of the bits payload: uint8 [B, gh,
    ceil(gw/8)] -> int32 [B], ``word_cluster_counts_plain`` of
    ``bits_to_words``."""
    return word_cluster_counts_plain(bits_to_words(bits, geom), geom)


def _check(t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape[1:]) != shape or t.dim() != len(shape) + 1:
        raise ValueError(f"{name} must be [B, {', '.join(map(str, shape))}]"
                         f", got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def outputs(like: torch.Tensor, b: int):
    """A launch's outputs on the device of ``like``: counts int32 [b] and
    motion bool [b].  Two allocations: one buffer with counts and motion as
    views of it took longer on the card's host (PERF.md)."""
    return (like.new_empty((b,), dtype=torch.int32),
            like.new_empty((b,), dtype=torch.bool))


def _launch_rows(rows: torch.Tensor, geom: GridGeometry, pitch: int,
                 need: int):
    """The word-domain kernel on rows of ``pitch`` bytes; counted on
    ``cluster_words_op.launches``."""
    b = rows.shape[0]
    counts, motion = outputs(rows, b)
    _build.launch("mvt_word_cluster_counts", cluster_words_op, rows.device,
                  rows.data_ptr(), b, geom.gh, pitch, geom.gw, geom.y_min,
                  geom.y_max, need, counts.data_ptr(), motion.data_ptr())
    return counts, motion


def cluster_words_op(words: torch.Tensor, geom: GridGeometry,
                     clusters_needed: int):
    """words int32 [B, used] -> (counts int32 [B], motion bool [B]).

    A CUDA tensor goes to the word-domain kernel, which reads each row as
    4 * gww bytes (``cluster_words_op.launches`` counts its launches, those
    of ``cluster_bits_op`` too); a CPU tensor to
    ``word_cluster_counts_plain``; any other device raises.
    """
    gww, used, _ = word_geometry(geom)
    _check(words, torch.int32, (used,), "words")
    need = max(1, clusters_needed)
    kind = words.device.type
    if kind == "cuda":
        return _launch_rows(words, geom, 4 * gww, need)
    if kind == "cpu":
        counts = word_cluster_counts_plain(words, geom)
        return counts, counts >= need
    raise RuntimeError(
        f"cluster_words_op runs on cuda or cpu tensors, not {words.device}")


cluster_words_op.launches = 0


def cluster_bits_op(bits: torch.Tensor, geom: GridGeometry,
                    clusters_needed: int):
    """bits uint8 [B, gh, ceil(gw/8)] (the native mvt_scan_bits layout)
    -> (counts int32 [B], motion bool [B]), the decisions of
    ``cluster_words_op`` on ``repack_bits_words(bits)``.

    A CUDA tensor goes to the word-domain kernel at the bits' own pitch, no
    repack (counted on ``cluster_words_op.launches``); a CPU tensor to
    ``bits_cluster_counts_plain``; any other device raises.
    """
    pitch = (geom.gw + 7) // 8
    _check(bits, torch.uint8, (geom.gh, pitch), "bits")
    need = max(1, clusters_needed)
    kind = bits.device.type
    if kind == "cuda":
        return _launch_rows(bits, geom, pitch, need)
    if kind == "cpu":
        counts = bits_cluster_counts_plain(bits, geom)
        return counts, counts >= need
    raise RuntimeError(
        f"cluster_bits_op runs on cuda or cpu tensors, not {bits.device}")


def cluster_staged_op(slot, frames: int, geom: GridGeometry, pitch: int,
                      clusters_needed: int) -> None:
    """One staged device batch of the bits (pitch ceil(gw/8)) or words (4
    * gww) payload: ``frames`` frames of rows in ``slot``'s pinned host
    rows (``models.staging.Slot``), decided by the word-domain kernel into
    its pinned host motion.  One native call on PyTorch's current stream
    copies the rows to the card, launches the kernel as ``cluster_bits_op``
    does, copies the motion back and records the slot's event (counted on
    ``cluster_words_op.launches``); the motion is there once the event
    has completed."""
    if not 1 <= frames <= slot.frames or \
            frames * geom.gh * pitch > slot.rows.nbytes:
        raise ValueError(f"{frames} frames of {geom.gh} x {pitch} bytes do "
                         f"not fit a slot of {slot.frames} frames, "
                         f"{slot.rows.nbytes} bytes")
    host_rows, rows, counts, motion, host_motion, event = slot.pointers
    _build.launch("mvt_word_cluster_batch", cluster_words_op, slot.device,
                  host_rows, rows, frames, geom.gh, pitch, geom.gw,
                  geom.y_min, geom.y_max, max(1, clusters_needed), counts,
                  motion, host_motion, event)


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
    b = votes.shape[0]
    counts, motion = outputs(votes, b)
    _build.launch("mvt_cluster_map_counts", cluster_map_op, votes.device,
                  votes.data_ptr(), int(votes.dtype == torch.int32), b,
                  geom.gh, geom.gw, geom.y_min, geom.y_max, threshold, need,
                  counts.data_ptr(), motion.data_ptr())
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
        return _launch_map(votes, geom, threshold, need)
    if votes.device.type == "cpu":
        counts = cluster_map_counts_plain(votes, geom, threshold)
        return counts, counts >= need
    raise RuntimeError(
        f"cluster_map_op runs on cuda or cpu tensors, not {votes.device}")


cluster_map_op.launches = 0
