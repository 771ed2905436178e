"""The bit-word formulation of the vote-level cluster rule, on the CPU.

The kernels ``csrc/cluster_map.cu`` and ``csrc/mv_cluster.cu`` do not walk
a vote grid cell by cell: they pack the bits ``votes >= threshold`` into
the word domain's row-padded words (bit l of word c of row y is cell
x = 32c + l, ``gww = ceil(gw / 32)`` words a row) and run the word rule of
``csrc/word_cluster.cu`` on them, a row off the grid reading as the fill
word (all ones when 0 >= threshold, else 0).  The raw-MV kernel keeps
only the rows of the centre window in its histogram, since no MV outside
them is kept, and sets a cell's bit with the vote that lifts the cell to
the threshold, which packs the same words as ``votes >= threshold``.
``cluster_map_model`` and ``mv_cluster_model`` restate those steps in
NumPy; the tests hold them equal to the port's plain
versions, to the JAX ``cluster_counts_traced`` (XLA on the CPU) and to the
word domain's own packing, ``repack_bits_words``.  Integer math, so the
tolerance is exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.ops import cluster as jax_cluster
from mvtrim_tpu_torch.core import Config, GridGeometry
from mvtrim_tpu_torch.ops import cluster as torch_cluster
from mvtrim_tpu_torch.ops import mv_vote as torch_mv


GEOMETRIES = [  # chip_smoke.GEOMETRIES: (width, height, vertical_mask)
    (1920, 1080, 0.05),   # gw=120, not a multiple of 32
    (3840, 2160, 0.05),   # 4K
    (360, 240, 0.0),      # margin 0: rows 0 and gh-1 are centres
    (200, 144, 0.05),     # gw=13, less than one word
    (1024, 576, 0.05),    # gw=64, a multiple of 32
    (512, 2048, 0.0),     # one word per row, margin 0
]
# the other geometries chip_smoke.MAP_CASES holds K3 at
MAP_CASE_GEOMETRIES = [(1000, 562, 0.0)]  # gw 63, margin 0
THRESHOLDS = (-1, 0, 1, 2, 255, 2 ** 31 - 1)
WORD = 0xFFFFFFFF
SHIFT = 4


def geometry(dims_vm) -> GridGeometry:
    width, height, vm = dims_vm
    return GridGeometry.build(width, height, Config(vertical_mask=vm))


def pack_words(active: np.ndarray) -> np.ndarray:
    """bool [B, rows, gw] -> uint32 [B, rows, gww]: bit l of word c of a
    row is cell 32c + l, bits past gw 0 (what a warp's ballot packs)."""
    b, rows, gw = active.shape
    gww = -(-gw // 32)
    cells = np.zeros((b, rows, gww * 32), bool)
    cells[..., :gw] = active
    return np.packbits(cells, axis=2, bitorder="little").view("<u4")


def center_bits(gw: int) -> np.ndarray:
    """uint64 [gww]: the bits of each word with x in [1, gw - 2]."""
    x = np.arange(-(-gw // 32) * 32).reshape(-1, 32)
    inside = (x >= 1) & (x <= gw - 2)
    return (inside.astype(np.uint64) << np.arange(32, dtype=np.uint64)
            ).sum(axis=1, dtype=np.uint64)


def word_rule_counts(words: np.ndarray, w_lo: int, y_lo: int, y_hi: int,
                     gw: int, fill: int) -> np.ndarray:
    """The word rule over rows [y_lo, y_hi) of words uint32 [B, n, gww]
    holding rows [w_lo, w_lo + n); a row outside them reads as ``fill``.
    All arithmetic on the unsigned 32-bit values."""
    w = words.astype(np.uint64)
    b, _, gww = w.shape
    edge = np.full((b, 1, gww), fill, np.uint64)
    ext = np.concatenate([edge, w, edge], axis=1)  # rows w_lo - 1 ..
    r0 = y_lo - w_lo + 1
    cur = ext[:, r0:r0 + max(y_hi - y_lo, 0)]
    up = ext[:, r0 - 1:r0 - 1 + cur.shape[1]]
    down = ext[:, r0 + 1:r0 + 1 + cur.shape[1]]
    zero = np.zeros(cur.shape[:2] + (1,), np.uint64)
    prev = np.concatenate([zero, cur[..., :-1]], axis=2)
    nxt = np.concatenate([cur[..., 1:], zero], axis=2)
    left = ((cur << 1) & WORD) | (prev >> 31)
    right = (cur >> 1) | ((nxt << 31) & WORD)
    cl = cur & (left | right | up | down) & center_bits(gw)
    return np.bitwise_count(cl).sum(axis=(1, 2)).astype(np.int32)


def fill_word(threshold: int) -> int:
    return WORD if threshold <= 0 else 0


def cluster_map_model(votes: np.ndarray, geom: GridGeometry,
                      threshold: int) -> np.ndarray:
    """cluster_map.cu: the window's rows and one more on each side inside
    the grid, packed at the threshold, then the word rule."""
    y_lo, y_hi = max(geom.y_min, 0), min(geom.y_max, geom.gh)
    w_lo, w_hi = max(y_lo - 1, 0), min(y_hi + 1, geom.gh)
    words = pack_words(votes[:, w_lo:w_hi].astype(np.int64) >= threshold)
    return word_rule_counts(words, w_lo, y_lo, y_hi, geom.gw,
                            fill_word(threshold))


def mv_cluster_model(mvs: np.ndarray, counts: np.ndarray,
                     geom: GridGeometry, bound: int, threshold: int,
                     shift: int) -> np.ndarray:
    """mv_cluster.cu: votes of the kept MVs in a histogram of the window's
    rows only; words that start as the fill word (bits past gw too, which
    the centre mask never reads) and gain the bit of each cell whose votes
    reach the threshold; then the word rule with every row outside the
    window reading as the fill word."""
    b, m, _ = mvs.shape
    f = mvs.astype(np.int64)
    d = f[..., :2] - f[..., 2:]
    mag = ((d * d).sum(axis=2) + 2 ** 31) % 2 ** 32 - 2 ** 31  # int32 wrap
    gx, gy = f[..., 0] >> shift, f[..., 1] >> shift
    y_lo, y_hi = max(geom.y_min, 0), min(geom.y_max, geom.gh)
    rows = max(y_hi - y_lo, 0)
    keep = ((np.arange(m)[None] < counts[:, None]) & (mag >= bound)
            & (gx >= 0) & (gx < geom.gw) & (gy >= y_lo) & (gy < y_hi))
    flat = (np.arange(b)[:, None] * rows + gy - y_lo) * geom.gw + gx
    hist = np.bincount(flat[keep], minlength=b * rows * geom.gw)
    active = hist.reshape(b, rows, geom.gw) >= max(threshold, 1)
    words = pack_words(active) | np.uint32(fill_word(threshold))
    return word_rule_counts(words, y_lo, y_lo, y_hi, geom.gw,
                            fill_word(threshold))


def seeded_votes(seed: int, b: int, geom: GridGeometry, dtype) -> np.ndarray:
    """[b, gh, gw] votes 0..3 with cells at the top of the type's range
    (and, for int32, negative votes), so every threshold splits them."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 4, size=(b, geom.gh, geom.gw)).astype(np.int64)
    top = rng.random(v.shape)
    if dtype == np.uint8:
        v[top < 0.05] = 255
        v[(top >= 0.05) & (top < 0.1)] = 254
    else:
        v[top < 0.03] = 2 ** 31 - 1
        v[(top >= 0.03) & (top < 0.06)] = 300
        v[(top >= 0.06) & (top < 0.1)] = -(2 ** 31)
        v[(top >= 0.1) & (top < 0.15)] = -1
    return v.astype(dtype)


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("dims_vm", GEOMETRIES + MAP_CASE_GEOMETRIES)
def test_vote_words_match_plain_and_jax(dims_vm, dtype, threshold):
    geom = geometry(dims_vm)
    votes = seeded_votes(dims_vm[0] + dims_vm[1] + threshold % 97, 3, geom,
                         dtype)
    model = cluster_map_model(votes, geom, threshold)
    plain = torch_cluster.cluster_map_counts_plain(torch.from_numpy(votes),
                                                   geom, threshold)
    np.testing.assert_array_equal(model, plain.numpy())
    jax_geom = JaxGeometry(**dataclasses.asdict(geom))
    traced = jax_cluster.cluster_counts_traced(
        jnp.asarray(votes.astype(np.int32)), jax_geom, jnp.int32(threshold))
    np.testing.assert_array_equal(model, np.asarray(traced))
    if 0 < threshold <= 2:
        assert model.any()  # the seeded grids do form clusters


@pytest.mark.parametrize("dims_vm", GEOMETRIES)
def test_packed_words_are_the_word_domain_layout(dims_vm):
    """What a warp packs is K1's payload: repack_bits_words of the same
    cells, read as unsigned words."""
    geom = geometry(dims_vm)
    active = np.random.default_rng(dims_vm[1]).random(
        (2, geom.gh, geom.gw)) < 0.4
    words = torch_cluster.repack_bits_words(
        np.packbits(active, axis=2, bitorder="little"), geom)
    np.testing.assert_array_equal(pack_words(active).reshape(2, -1),
                                  words.view(np.uint32))


def seeded_mvs(seed: int, counts: np.ndarray, m: int, width: int,
               height: int, hot: int = 0) -> np.ndarray:
    """int16 [B, m, 4]: dst over the frame and 32 pixels past each edge,
    displacements up to 8, half of each list in one 64x48 box; with
    ``hot`` = 1 or 2 every MV lands in one cell, or in two neighbouring
    cells, at (width / 2, height / 2)."""
    rng = np.random.default_rng(seed)
    b = len(counts)
    mvs = np.zeros((b, m, 4), np.int16)
    mvs[..., 0] = rng.integers(-32, width + 32, size=(b, m))
    mvs[..., 1] = rng.integers(-32, height + 32, size=(b, m))
    box = m // 2
    mvs[:, :box, 0] = rng.integers(width // 4, width // 4 + 64, size=(b, box))
    mvs[:, :box, 1] = rng.integers(height // 4, height // 4 + 48,
                                   size=(b, box))
    if hot:
        cell_x = (width // 2) >> SHIFT
        mvs[..., 0] = ((cell_x + np.arange(m) % hot) << SHIFT) + 3
        mvs[..., 1] = (((height // 2) >> SHIFT) << SHIFT) + 5
    mvs[..., 2:] = mvs[..., :2] - rng.integers(-8, 9, size=(b, m, 2))
    return mvs


@pytest.mark.parametrize("hot", [0, 1, 2])
@pytest.mark.parametrize("threshold", (-1, 0, 1, 2, 255))
@pytest.mark.parametrize("dims_vm", GEOMETRIES)
def test_mv_words_match_plain(dims_vm, threshold, hot):
    geom = geometry(dims_vm)
    m = 300
    counts = np.array([0, 1, 17, 150, 299, 300], np.int32)
    mvs = seeded_mvs(dims_vm[0] + threshold % 89 + hot, counts, m,
                     *dims_vm[:2], hot=hot)
    for bound in (0, 16, 17):
        model = mv_cluster_model(mvs, counts, geom, bound, threshold, SHIFT)
        plain = torch_mv.mv_cluster_counts_plain(
            torch.from_numpy(mvs), torch.from_numpy(counts), geom, bound,
            threshold, SHIFT)
        np.testing.assert_array_equal(model, plain.numpy())


def test_mv_rows_outside_the_window_are_fill_rows():
    """The margin rows the raw-MV histogram leaves out: an MV landing
    there is dropped, so at threshold 0 they are active like off-grid
    rows, and a row of the window next to them counts its centre cells."""
    geom = geometry((1920, 1080, 0.05))
    assert geom.y_min > 1
    mvs = np.zeros((1, 4, 4), np.int16)
    mvs[0, :, 1] = (geom.y_min - 1) << SHIFT  # above the window: dropped
    counts = np.array([4], np.int32)
    full = mv_cluster_model(mvs, counts, geom, 0, 0, SHIFT)
    rows = min(geom.y_max, geom.gh) - geom.y_min
    assert full.tolist() == [rows * (geom.gw - 2)]
    plain = torch_mv.mv_cluster_counts_plain(
        torch.from_numpy(mvs), torch.from_numpy(counts), geom, 0, 0, SHIFT)
    assert plain.tolist() == full.tolist()
