// The cluster rule on bit words, shared by word_cluster.cu, cluster_map.cu,
// mv_cluster.cu and bench_controls.cu (C5's rule, the controls' block sum).
//
// Layout (the word-domain payload's): a grid [gh, gw] is gh rows of gww =
// ceil(gw / 32) words; bit l of word c of row y is cell x = 32c + l; bits
// past gw are 0.  The rule over one word w of a row, with prev / next the
// row's words c-1 / c+1 (0 past the row's ends) and up / down the words c of
// rows y-1 / y+1:
//
//   left  = (w << 1) | (prev >> 31)
//   right = (w >> 1) | (next << 31)
//   cl    = w & (left | right | up | down) & center_bits(c, gw)
//
// and a frame counts the set bits of cl over its centre rows.  All bit
// arithmetic is uint32_t, so every >> is logical.
//
// The vote-level rule runs on the same words.  For integers,
//
//   min(v, max(left, right, up, down)) >= thr
//
// is "v >= thr and some 4-neighbour >= thr", so packing the bits v >= thr
// and applying the word rule counts the same cells.  A cell outside the grid
// is vote 0, so a row above or below the grid reads as the fill word: all
// ones when 0 >= thr, else 0.  Left and right of a centre cell (x in
// [1, gw-2]) always lie inside its row, so only rows need that fill.

#pragma once

#include <cstdint>

namespace mvt {

constexpr unsigned kFullMask = 0xffffffffu;

// Bits k of word c whose cell x = 32c + k lies in [1, gw - 2].
__device__ __forceinline__ uint32_t center_bits(int c, int gw) {
    const int x0 = 32 * c;
    const int k_lo = max(0, 1 - x0);
    const int k_hi = min(31, gw - 2 - x0);
    if (k_hi < k_lo) return 0u;
    const uint32_t upto_hi =
        k_hi == 31 ? kFullMask : ((1u << (k_hi + 1)) - 1u);
    return upto_hi & (kFullMask << k_lo);
}

// The cells of w with an active 4-neighbour (before the centre mask).
__device__ __forceinline__ uint32_t cluster_bits(uint32_t w, uint32_t prev,
                                                 uint32_t next, uint32_t up,
                                                 uint32_t down) {
    const uint32_t left = (w << 1) | (prev >> 31);
    const uint32_t right = (w >> 1) | (next << 31);
    return w & (left | right | up | down);
}

// What a row of vote-0 cells packs to at threshold thr.
__device__ __forceinline__ uint32_t fill_word(int thr) {
    return thr <= 0 ? kFullMask : 0u;
}

// Packs rows [lo, hi) of a vote grid into words[(y - lo) * gww + c] with
// __ballot_sync: lane l of word c holds cell x = 32c + l, set when
// vote(y, x) >= thr (vote is called only for x < gw).  Warp `warp` of
// `warps` takes rows lo + warp, lo + warp + warps, ..., kRows of them at a
// time, so each warp has kRows reads in flight before its ballots.
template <int kRows, typename Vote>
__device__ __forceinline__ void pack_rows(Vote vote, uint32_t* words, int lo,
                                          int hi, int gw, int gww, int thr,
                                          int warp, int warps) {
    const int lane = threadIdx.x & 31;
    for (int r0 = warp; r0 < hi - lo; r0 += warps * kRows) {
        for (int c = 0; c < gww; ++c) {
            const int x = 32 * c + lane;
            bool active[kRows];
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
                const int r = r0 + u * warps;
                active[u] = r < hi - lo && x < gw && vote(lo + r, x) >= thr;
            }
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
                const int r = r0 + u * warps;  // the same in every lane
                const uint32_t word = __ballot_sync(kFullMask, active[u]);
                if (lane == 0 && r < hi - lo) words[r * gww + c] = word;
            }
        }
    }
}

// pack_rows with four cells a lane, for loads four cells wide: lane l of a
// 128-cell span s reads cells x = 128s + 4l .. +3 as nibble(y, x) (bit i set
// when cell x + i is active; called only for x < gw, and gw % 4 == 0), and
// three xor-shuffles OR the nibbles of lanes 8c'..8c'+7 into word 4s + c'.
template <int kRows, typename Nibble>
__device__ __forceinline__ void pack_rows4(Nibble nibble, uint32_t* words,
                                           int lo, int hi, int gw, int gww,
                                           int warp, int warps) {
    const int lane = threadIdx.x & 31;
    for (int r0 = warp; r0 < hi - lo; r0 += warps * kRows) {
        for (int s = 0; 128 * s < gw; ++s) {
            const int x = 128 * s + 4 * lane;
            uint32_t nib[kRows];
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
                const int r = r0 + u * warps;
                nib[u] = r < hi - lo && x < gw ? nibble(lo + r, x) : 0u;
            }
            const int c = 4 * s + (lane >> 3);
#pragma unroll
            for (int u = 0; u < kRows; ++u) {
                const int r = r0 + u * warps;
                uint32_t w = nib[u] << (4 * (lane & 7));
                w |= __shfl_xor_sync(kFullMask, w, 1);
                w |= __shfl_xor_sync(kFullMask, w, 2);
                w |= __shfl_xor_sync(kFullMask, w, 4);
                if (r < hi - lo && (lane & 7) == 0 && c < gww)
                    words[r * gww + c] = w;
            }
        }
    }
}

// This thread's count of cluster cells in rows [y_lo, y_hi), over the words
// j = first, first + stride, ... of those rows.  words holds rows
// [w_lo, w_hi) (w_lo <= y_lo, y_hi <= w_hi) as words[(y - w_lo) * gww + c];
// a row outside them reads as `fill`.
__device__ __forceinline__ uint32_t count_rows(const uint32_t* words,
                                               int w_lo, int w_hi, int gww,
                                               int gw, int y_lo, int y_hi,
                                               uint32_t fill, int first,
                                               int stride) {
    const int n = max(y_hi - y_lo, 0) * gww;
    uint32_t total = 0;
    for (int j = first; j < n; j += stride) {
        const int r = j / gww;
        const int c = j - r * gww;
        const int y = y_lo + r;
        const uint32_t* row = words + (y - w_lo) * gww;
        const uint32_t w = row[c];
        const uint32_t prev = c > 0 ? row[c - 1] : 0u;
        const uint32_t next = c + 1 < gww ? row[c + 1] : 0u;
        const uint32_t up = y > w_lo ? row[c - gww] : fill;
        const uint32_t down = y + 1 < w_hi ? row[c + gww] : fill;
        total += __popc(cluster_bits(w, prev, next, up, down) &
                        center_bits(c, gw));
    }
    return total;
}

// The sum of v over the block (blockDim.x a multiple of 32), returned in
// thread 0; sums holds 32 words.  Every thread of the block calls it.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* sums) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(kFullMask, v, off);
    if (lane == 0) sums[warp] = v;
    __syncthreads();
    uint32_t sum = 0;
    if (warp == 0) {
        sum = lane < static_cast<int>(blockDim.x >> 5) ? sums[lane] : 0u;
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_down_sync(kFullMask, sum, off);
    }
    return sum;
}

}  // namespace mvt
