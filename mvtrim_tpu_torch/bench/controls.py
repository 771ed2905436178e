"""The bench's controls: C1-C10, with their plain PyTorch versions.

A control is measured beside a product kernel and answers what that
kernel's launch could do at best on the card, or what one stage of it
costs:

* C2 ``sad_stream_control`` (``csrc/bench_controls.cu``) keeps K6's launch
  (``sad_grid_op``: grid, CTA shape, load width), reads every byte K6
  reads and does trivial integer arithmetic: its rate is the practical
  memory ceiling of that launch.
* C1 ``word_stream_control`` reads K1's rows (``cluster_bits_op`` /
  ``cluster_words_op``) on a launch made for the card (a warp a frame,
  every 16-byte load in flight at once): what the card can stream of
  them.  K1 against C1 is what K1 could gain on C1's launch.
* C3 ``mv_stream_control``, C9 ``mv_votes_control`` (``noclu``) and C5
  ``mv_compute_control`` read K4+K5's ragged payload (``mv_cluster_op``)
  on a launch made for the card (``csrc/bench_controls.cu``: a frame to
  a small CTA, a persistent grid taking the frames in turn): C3 streams
  the rows below the counts with a trivial sum, what the card can stream
  of the payload; C9 scatters every MV K4+K5's keep rule keeps into a
  32-bit histogram and counts them, what the card can scatter of it; C5
  runs K4+K5's whole rule (scatter, the bit the thr-th vote sets, the
  word rule, the reduction) with the frame index held at frame 0, so
  every frame decides the one frame read from the L2: the arithmetic
  ceiling of the decision.  K4+K5 against C5 is what moving K4+K5 onto
  this launch could gain, rule included; against C9 without the rule; C9
  against C3 is the scatter's own cost.
* C4 ``sad_compute_control`` is K6's body (``csrc/sad_block.cu``)
  instantiated a second time with the frame index held at one resident
  frame, so the same loads and arithmetic run from the L2: its rate is
  the arithmetic ceiling of K6's body.
* the capacity controls (``csrc/bench_controls.cu``) are K4+K5's launch
  (one CTA a frame) over all M slots a frame, as
  ``benchmarks/mv_bench.py``'s TPU controls read them: C6
  ``mv_capacity_control`` (``ctrl``), C7
  ``mv_capacity_control_sub`` (``ctrlsub``, a second copy of dst_x), C8
  ``mv_capacity_control_mm`` (``ctrlmm``, the fields' low bytes).  C6
  against C3 is what reading by capacity, not by count, costs.
* C10 ``mv_matrix_control`` (``mmctrl``) runs the shapes of the TPU's
  one-hot vote product on the tensor cores (int8 operands, int32 sums):
  what the scatter as a matrix product would cost on the card.  C5, not
  C10, is K4+K5's compute control.

Each wrapper checks its inputs as the product wrapper does; a CUDA tensor
launches its kernel (counted on ``<wrapper>.launches``), a CPU tensor runs
the plain version, and any other device raises.  Nothing on the scan
paths calls them.
"""

from __future__ import annotations

import functools

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


# --- C1: K1's rows, a warp a frame ---

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
    """The bits or words payload of K1 -> int32 [B], the stream of K1's
    rows (``word_stream_control_plain`` of ``word_rows``)."""
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


# --- C3: K4+K5's payload, a frame to a small CTA ---

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
    """K4+K5's payload -> int32 [B], the stream of its rows below the
    counts (``mv_stream_control_plain``)."""
    mv_ops._check_mvs(mvs, counts)
    if _on(mvs, "mv_stream_control") == "cpu":
        return mv_stream_control_plain(mvs, counts)
    sums = mvs.new_empty((mvs.shape[0],), dtype=torch.int32)
    _build.launch("mvt_mv_stream_control", mv_stream_control, mvs.device,
                  mvs.data_ptr(), counts.data_ptr(), mvs.shape[0],
                  mvs.shape[1], sums.data_ptr())
    return sums


mv_stream_control.launches = 0


# --- C5: K4+K5's decision over one held frame, a frame to a small CTA ---

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
    from K4+K5's rule with the frame index held at frame 0
    (``mv_compute_control_plain``); the histogram in global scratch where
    ``mv_cluster_op``'s would be."""
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


# --- C6, C7, C8: C3's launch over all M slots ---

def _wrapped(total: torch.Tensor) -> torch.Tensor:
    return mv_ops._wrap_int32(total).to(torch.int32)


def mv_capacity_control_plain(mvs: torch.Tensor,
                              counts: torch.Tensor) -> torch.Tensor:
    """mvs int16 [B, M, 4] + counts int32 [B] -> int32 [B]: count[b] plus
    the sum of the four fields of every slot k < M, whatever the count
    (mv_bench.py's ctrl), wrapped to int32."""
    return _wrapped(mvs.sum(dim=(1, 2), dtype=torch.int64)
                    + counts.to(torch.int64))


def mv_capacity_control_sub_plain(mvs: torch.Tensor, counts: torch.Tensor,
                                  sub: torch.Tensor) -> torch.Tensor:
    """``mv_capacity_control_plain`` plus the sum of sub int16 [B, M] (a
    second copy of dst_x: mv_bench.py's ctrlsub), wrapped to int32."""
    return _wrapped(mvs.sum(dim=(1, 2), dtype=torch.int64)
                    + sub.sum(dim=1, dtype=torch.int64)
                    + counts.to(torch.int64))


# the largest M at which the TPU's ctrlmm is exact: its bf16 ones-matmul
# sums in float32, exact while 4 * 255 * M < 2^24
MM_EXACT_M = 16448


def mv_capacity_control_mm_plain(mvs: torch.Tensor,
                                 counts: torch.Tensor) -> torch.Tensor:
    """mvs int16 [B, M, 4] + counts int32 [B] -> int32 [B]: count[b] plus
    the sum over every slot k < M of (v & 255) of each field (so -3 adds
    253), in integers, wrapped to int32.  mv_bench.py's ctrlmm computes the
    same in float32 and is exact only while 4 * 255 * M < 2^24, that is M
    <= MM_EXACT_M = 16,448 (the bench's 4K capacity, 16,384, is inside)."""
    return _wrapped((mvs & 255).sum(dim=(1, 2), dtype=torch.int64)
                    + counts.to(torch.int64))


def _capacity(counter, mode: int, mvs: torch.Tensor, counts: torch.Tensor,
              sub: torch.Tensor | None = None) -> torch.Tensor:
    sums = mvs.new_empty((mvs.shape[0],), dtype=torch.int32)
    _build.launch("mvt_mv_capacity_control", counter, mvs.device,
                  mvs.data_ptr(), counts.data_ptr(),
                  None if sub is None else sub.data_ptr(), mvs.shape[0],
                  mvs.shape[1], mode, sums.data_ptr())
    return sums


def mv_capacity_control(mvs: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """K4+K5's payload -> int32 [B], C3's launch over all M slots
    (``mv_capacity_control_plain``)."""
    mv_ops._check_mvs(mvs, counts)
    if _on(mvs, "mv_capacity_control") == "cpu":
        return mv_capacity_control_plain(mvs, counts)
    return _capacity(mv_capacity_control, 0, mvs, counts)


mv_capacity_control.launches = 0


def mv_capacity_control_sub(mvs: torch.Tensor, counts: torch.Tensor,
                            sub: torch.Tensor) -> torch.Tensor:
    """K4+K5's payload and sub int16 [B, M] (the caller's copy of dst_x),
    contiguous on the same device -> int32 [B]
    (``mv_capacity_control_sub_plain``)."""
    mv_ops._check_mvs(mvs, counts)
    if sub.dtype != torch.int16:
        raise TypeError(f"sub must be int16, got {sub.dtype}")
    if tuple(sub.shape) != tuple(mvs.shape[:2]):
        raise ValueError(f"sub must be [{mvs.shape[0]}, {mvs.shape[1]}], "
                         f"got {tuple(sub.shape)}")
    if sub.device != mvs.device:
        raise ValueError(f"sub on {sub.device}, mvs on {mvs.device}")
    if not sub.is_contiguous():
        raise ValueError("sub must be contiguous")
    if _on(mvs, "mv_capacity_control_sub") == "cpu":
        return mv_capacity_control_sub_plain(mvs, counts, sub)
    return _capacity(mv_capacity_control_sub, 1, mvs, counts, sub)


mv_capacity_control_sub.launches = 0


def mv_capacity_control_mm(mvs: torch.Tensor,
                           counts: torch.Tensor) -> torch.Tensor:
    """K4+K5's payload -> int32 [B] (``mv_capacity_control_mm_plain``)."""
    mv_ops._check_mvs(mvs, counts)
    if _on(mvs, "mv_capacity_control_mm") == "cpu":
        return mv_capacity_control_mm_plain(mvs, counts)
    return _capacity(mv_capacity_control_mm, 2, mvs, counts)


mv_capacity_control_mm.launches = 0


# --- C9: K4+K5's vote scatter without the rule ---

def mv_votes_control_plain(mvs: torch.Tensor, counts: torch.Tensor,
                           geom: GridGeometry, bound: int,
                           block_shift: int) -> torch.Tensor:
    """int32 [B]: each frame's kept MVs by K4+K5's keep rule
    (``mv_vote.keep_mask``), the sum of its votes (mv_bench.py's noclu):
    0 for a count <= 0, M slots read for a count above M."""
    keep, _, _ = mv_ops.keep_mask(mvs, counts, geom, bound, block_shift)
    return keep.sum(dim=1, dtype=torch.int64).to(torch.int32)


@functools.lru_cache(maxsize=256)
def votes_scratch_cells(batch: int, geom: GridGeometry,
                        device_index: int) -> int:
    """int32 cells of global histogram scratch C9 needs, 0 where its
    histograms fit in shared memory (the kernel's own answer)."""
    with torch.cuda.device(device_index):
        cells = _build.load_library().mvt_mv_votes_scratch(
            batch, geom.gh, geom.gw, geom.y_min, geom.y_max)
    if cells < 0:
        raise RuntimeError(f"scratch query failed: CUDA error {-cells}")
    return cells


def mv_votes_control(mvs: torch.Tensor, counts: torch.Tensor,
                     geom: GridGeometry, bound: int,
                     block_shift: int) -> torch.Tensor:
    """K4+K5's payload, geometry, bound and shift -> int32 [B]
    (``mv_votes_control_plain``) from the vote scatter into one 32-bit
    histogram a frame, without the rule."""
    mv_ops._check_mvs(mvs, counts)
    bound = max(-(1 << 63), min(int(bound), (1 << 63) - 1))
    if _on(mvs, "mv_votes_control") == "cpu":
        return mv_votes_control_plain(mvs, counts, geom, bound, block_shift)
    b, m, _ = mvs.shape
    dev = mvs.device
    sums = mvs.new_empty((b,), dtype=torch.int32)
    cells = votes_scratch_cells(b, geom, mv_ops._device_index(dev))
    scratch = torch.empty((cells,), dtype=torch.int32, device=dev) \
        if cells else None
    _build.launch("mvt_mv_votes_control", mv_votes_control, dev,
                  mvs.data_ptr(), counts.data_ptr(), b, m, geom.gh, geom.gw,
                  geom.y_min, geom.y_max, bound, block_shift,
                  None if scratch is None else scratch.data_ptr(), cells,
                  sums.data_ptr())
    return sums


mv_votes_control.launches = 0


# --- C10: the vote product's shapes on the tensor cores ---

def matrix_ops(geom: GridGeometry, b: int, m: int) -> int:
    """Tensor operations of C10 for b frames of M slots: 2 gh_p gw_p M_32
    a frame, M_32 being M rounded up to a multiple of 32 (the mma's
    depth)."""
    return 2 * geom.padded_gh * geom.padded_gw * (-(-m // 32) * 32) * b


def mv_matrix_control_plain(mvs: torch.Tensor,
                            geom: GridGeometry) -> torch.Tensor:
    """mvs int16 [B, M, 4] -> int32 [B]: gh_p * gw_p * sum over every slot
    k < M of ((dst_x ^ src_x) & (dst_y ^ src_y) & 1), in int64 and
    wrapped to int32, the closed form of mv_bench.py's mmctrl (every cell
    of its [gh_p, gw_p] product holds the sum)."""
    parity = (mvs[..., 0] ^ mvs[..., 2]) & (mvs[..., 1] ^ mvs[..., 3]) & 1
    return _wrapped(parity.sum(dim=1, dtype=torch.int64)
                    * (geom.padded_gh * geom.padded_gw))


def mv_matrix_control(mvs: torch.Tensor, geom: GridGeometry) -> torch.Tensor:
    """mvs int16 [B, M, 4] (counts play no part) -> int32 [B] by one
    s8 x s8 -> s32 tensor-core product a frame, every tile of it issued
    (``mv_matrix_control_plain``)."""
    mv_ops._check_mvs(mvs, None)
    if _on(mvs, "mv_matrix_control") == "cpu":
        return mv_matrix_control_plain(mvs, geom)
    sums = mvs.new_empty((mvs.shape[0],), dtype=torch.int32)
    _build.launch("mvt_mv_matrix_control", mv_matrix_control, mvs.device,
                  mvs.data_ptr(), mvs.shape[0], mvs.shape[1],
                  geom.padded_gh, geom.padded_gw, sums.data_ptr())
    return sums


mv_matrix_control.launches = 0

# name -> the wrapper whose count shows a launch
CONTROLS = {
    "word_stream_control": word_stream_control,
    "sad_stream_control": sad_stream_control,
    "mv_stream_control": mv_stream_control,
    "sad_compute_control": sad_compute_control,
    "mv_compute_control": mv_compute_control,
    "mv_capacity_control": mv_capacity_control,
    "mv_capacity_control_sub": mv_capacity_control_sub,
    "mv_capacity_control_mm": mv_capacity_control_mm,
    "mv_votes_control": mv_votes_control,
    "mv_matrix_control": mv_matrix_control,
}
