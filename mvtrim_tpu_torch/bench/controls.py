"""The bench's controls: C1-C5, with their plain PyTorch versions.

A control is measured beside a product kernel and answers what that
kernel's launch could do at best on the card:

* the stream controls (``csrc/bench_controls.cu``) keep a product kernel's
  launch (grid, CTA shape, frames a CTA, load width), read every byte it
  reads and do trivial integer arithmetic: their rate is the practical
  memory ceiling of that launch.  C1 ``word_stream_control`` follows K1
  (``cluster_bits_op`` / ``cluster_words_op``), C2 ``sad_stream_control``
  K6 (``sad_grid_op``), C3 ``mv_stream_control`` K4+K5
  (``mv_cluster_op``).
* the compute controls are the product bodies of ``csrc/sad_block.cu``
  (C4 ``sad_compute_control``) and ``csrc/mv_cluster.cu`` (C5
  ``mv_compute_control``) instantiated a second time with the frame index
  held at one resident frame, so the same loads and arithmetic run from
  the L2: their rate is the arithmetic ceiling of the product body.

Each wrapper checks its inputs as the product wrapper does; a CUDA tensor
launches its kernel (counted on ``<wrapper>.launches``), a CPU tensor runs
the plain version, and any other device raises.  Nothing on the scan
paths calls them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.types import GridGeometry
from ..ops import _build
from ..ops import cluster as cluster_ops
from ..ops import mv_vote as mv_ops
from ..ops import sad as sad_ops


def _on(t: torch.Tensor, name: str) -> str:
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise RuntimeError(f"{name} runs on cuda or cpu tensors, not "
                           f"{t.device}")
    return kind


# --- C1: K1's launch ---

def word_rows(payload: torch.Tensor, geom: GridGeometry) -> torch.Tensor:
    """K1's view of a payload as uint8 rows [B, gh, pitch]: the bits
    payload uint8 [B, gh, ceil(gw/8)] as it is, the words payload int32
    [B, gh * gww] as its bytes (pitch 4 * gww)."""
    gww, used, _ = cluster_ops.word_geometry(geom)
    if payload.dtype == torch.uint8:
        cluster_ops._check(payload, torch.uint8, (geom.gh, (geom.gw + 7) // 8),
                           "bits")
        return payload
    cluster_ops._check(payload, torch.int32, (used,), "words")
    return payload.view(torch.uint8).view(payload.shape[0], geom.gh, 4 * gww)


def word_stream_control_plain(rows: torch.Tensor,
                              geom: GridGeometry) -> torch.Tensor:
    """rows uint8 [B, gh, pitch] -> int32 [B]: per frame the sum of
    (word & 1) over every word of every row, word c of a row being bytes
    4c..4c+3 (so its bit 0 is bit 0 of byte 4c, inside the row for every c
    < ceil(gw / 32))."""
    gww = (geom.gw + 31) // 32
    return (rows[:, :, 0:4 * gww:4] & 1).sum(dim=(1, 2), dtype=torch.int32)


def word_stream_control(payload: torch.Tensor,
                        geom: GridGeometry) -> torch.Tensor:
    """The bits or words payload of K1 -> int32 [B], the stream control of
    K1's launch (``word_stream_control_plain`` of ``word_rows``)."""
    rows = word_rows(payload, geom)
    if _on(rows, "word_stream_control") == "cpu":
        return word_stream_control_plain(rows, geom)
    sums = rows.new_empty((rows.shape[0],), dtype=torch.int32)
    _build.launch("mvt_word_stream_control", word_stream_control,
                  rows.device, rows.data_ptr(), rows.shape[0], geom.gh,
                  rows.shape[2], geom.gw, sums.data_ptr())
    return sums


word_stream_control.launches = 0


# --- C2: K6's launch ---

def _block_sums(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """uint8 or int [N, H, W] -> int32 [N, ceil(H/bs), ceil(W/bs)] block
    sums, pixels past the frame counting 0."""
    n, h, w = x.shape
    gh, gw = -(-h // block_size), -(-w // block_size)
    x = F.pad(x, (0, gw * block_size - w, 0, gh * block_size - h))
    return x.reshape(n, gh, block_size, gw, block_size).sum(
        dim=(2, 4), dtype=torch.int32)


def sad_stream_control_plain(luma: torch.Tensor,
                             block_size: int) -> torch.Tensor:
    """luma uint8 [1 + B, H, W] -> int32 [B, gh, gw]: each block's count
    of bytes of frame b + 1 with bit 0 set, and for b = 0 also those of the
    carry (frame 0), so frame b's grid sum is sad_bench.py's ctrlf<B>
    count."""
    grid = _block_sums(luma[1:] & 1, block_size)
    grid[0] += _block_sums(luma[:1] & 1, block_size)[0]
    return grid


def _sad_launch(name: str, counter, luma: torch.Tensor, geom: GridGeometry,
                block_size: int, batch: int) -> torch.Tensor:
    _, h, w = luma.shape
    vec = sad_ops._vector_width(luma, block_size)
    grid = torch.empty((batch, geom.gh, geom.gw), dtype=torch.int32,
                       device=luma.device)
    _build.launch(name, counter, luma.device, luma.data_ptr(), batch, h, w,
                  block_size, geom.gh, geom.gw, vec, grid.data_ptr())
    return grid


def sad_stream_control(luma: torch.Tensor, geom: GridGeometry,
                       block_size: int) -> torch.Tensor:
    """luma uint8 [1 + B, H, W] (K6's input) -> int32 [B, gh, gw], the
    stream control of K6's launch (``sad_stream_control_plain``)."""
    sad_ops._check_luma(luma, geom, block_size)
    if _on(luma, "sad_stream_control") == "cpu":
        return sad_stream_control_plain(luma, block_size)
    return _sad_launch("mvt_sad_stream_control", sad_stream_control, luma,
                       geom, block_size, luma.shape[0] - 1)


sad_stream_control.launches = 0


# --- C4: K6's body over one resident frame ---

def sad_compute_control_plain(luma: torch.Tensor,
                              block_size: int) -> torch.Tensor:
    """luma uint8 [1 + B, H, W], B >= 1 -> int32 [B, gh, gw]: frame 0 the
    block SAD of frame 1 against the carry, every later frame that of frame
    1 against itself (zero), as sad_bench.py's compf1 reads one resident
    block."""
    first = sad_ops.sad_block_grid_plain(luma[:2], block_size)
    grid = first.new_zeros((luma.shape[0] - 1,) + tuple(first.shape[1:]))
    grid[0] = first[0]
    return grid


def sad_compute_control(luma: torch.Tensor, geom: GridGeometry,
                        block_size: int) -> torch.Tensor:
    """luma uint8 [1 + B, H, W], B >= 1 -> int32 [B, gh, gw] from K6's body
    with the frame index held at frame 1 (``sad_compute_control_plain``):
    the launch of K6 over a window, reading two planes from the L2."""
    sad_ops._check_luma(luma, geom, block_size)
    if luma.shape[0] < 2:
        raise ValueError("sad_compute_control needs the carry and a frame")
    if _on(luma, "sad_compute_control") == "cpu":
        return sad_compute_control_plain(luma, block_size)
    return _sad_launch("mvt_sad_compute_control", sad_compute_control, luma,
                       geom, block_size, luma.shape[0] - 1)


sad_compute_control.launches = 0


# --- C3: K4+K5's launch ---

def mv_stream_control_plain(mvs: torch.Tensor,
                            counts: torch.Tensor) -> torch.Tensor:
    """mvs int16 [B, M, 4] + counts int32 [B] -> int32 [B]: count[b] plus
    the sum of the four fields of MVs k < min(count[b], M), wrapped to
    int32 as the kernel's 32-bit sum."""
    b, m, _ = mvs.shape
    n = counts.to(torch.int64).clamp(0, m)
    keep = torch.arange(m, device=mvs.device)[None, :] < n[:, None]
    s = (mvs.sum(dim=2, dtype=torch.int64) * keep).sum(dim=1)
    return mv_ops._wrap_int32(s + counts.to(torch.int64)).to(torch.int32)


def mv_stream_control(mvs: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """K4+K5's payload -> int32 [B], the stream control of its launch
    (``mv_stream_control_plain``)."""
    mv_ops._check_mvs(mvs, counts)
    if _on(mvs, "mv_stream_control") == "cpu":
        return mv_stream_control_plain(mvs, counts)
    sums = mvs.new_empty((mvs.shape[0],), dtype=torch.int32)
    _build.launch("mvt_mv_stream_control", mv_stream_control, mvs.device,
                  mvs.data_ptr(), counts.data_ptr(), mvs.shape[0],
                  mvs.shape[1], sums.data_ptr())
    return sums


mv_stream_control.launches = 0


# --- C5: K4+K5's body over one resident frame ---

def mv_compute_control_plain(mvs: torch.Tensor, counts: torch.Tensor,
                             geom: GridGeometry, bound: int,
                             vectors_needed: int, clusters_needed: int,
                             block_shift: int):
    """(counts int32 [B], motion bool [B]): frame 0's decision by
    ``mv_cluster_op``'s rule, for every frame."""
    b = mvs.shape[0]
    first = mv_ops.mv_cluster_counts_plain(mvs[:1], counts[:1], geom, bound,
                                           vectors_needed, block_shift)
    out = first.expand(b).clone()
    need = max(1, clusters_needed)
    return out, (out >= need) & (counts[:1] > 0)


def mv_compute_control(mvs: torch.Tensor, counts: torch.Tensor,
                       geom: GridGeometry, bound: int, vectors_needed: int,
                       clusters_needed: int, block_shift: int):
    """``mv_cluster_op``'s arguments -> (counts int32 [B], motion bool [B])
    from K4+K5's body with the frame index held at frame 0
    (``mv_compute_control_plain``)."""
    mv_ops._check_mvs(mvs, counts)
    if mvs.shape[0] < 1:
        raise ValueError("mv_compute_control needs a frame")
    thr = max(-(1 << 31), min(int(vectors_needed), (1 << 31) - 1))
    bound = max(-(1 << 63), min(int(bound), (1 << 63) - 1))
    if _on(mvs, "mv_compute_control") == "cpu":
        return mv_compute_control_plain(mvs, counts, geom, bound, thr,
                                        clusters_needed, block_shift)
    b, m, _ = mvs.shape
    dev = mvs.device
    got, motion = cluster_ops.outputs(mvs, b)
    cells = mv_ops._scratch_cells(b, geom, mv_ops._device_index(dev), False)
    scratch = torch.empty((cells,), dtype=torch.int32, device=dev) \
        if cells else None
    _build.launch("mvt_mv_compute_control", mv_compute_control, dev,
                  mvs.data_ptr(), counts.data_ptr(), b, m, geom.gh, geom.gw,
                  geom.y_min, geom.y_max, bound, thr,
                  max(1, clusters_needed), block_shift,
                  None if scratch is None else scratch.data_ptr(), cells,
                  got.data_ptr(), motion.data_ptr())
    return got, motion


mv_compute_control.launches = 0

# name -> the wrapper whose count shows a launch
CONTROLS = {
    "word_stream_control": word_stream_control,
    "sad_stream_control": sad_stream_control,
    "mv_stream_control": mv_stream_control,
    "sad_compute_control": sad_compute_control,
    "mv_compute_control": mv_compute_control,
}
