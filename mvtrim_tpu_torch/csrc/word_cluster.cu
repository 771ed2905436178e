// Word-domain cluster count for Hopper (sm_90a).
//
// Replaces the TPU kernel mvtrim_tpu/ops/cluster.py:word_cluster_counts_T
// (make_cluster_words_op_pallas_T), which is also the math of the lane-major
// word_cluster_counts (make_cluster_words_op_pallas).
//
// Input: words int32 [B, used], contiguous, used = gh * gww, gww =
// ceil(gw / 32).  Bit k of word c in row y is grid cell x = 32c + k (the
// layout repack_bits_words and the native mvt_scan_words emit).  Per word:
//
//   left  = (w << 1) | (word c-1 of the row >> 31)     0 past the row edge
//   right = (w >> 1) | (word c+1 of the row << 31)     0 past the row edge
//   up    = word at row y-1, down = word at row y+1    0 outside [0, gh)
//   cl    = w & (left | right | up | down) & center
//
// center holds the bits with x in [1, gw-2] for rows y in [y_min, y_max),
// computed from gw, y_min and y_max; rows outside the window are never read
// as centres.  counts[b] = sum of __popc(cl), motion[b] = counts[b] >=
// max(1, clusters_needed).  All bit arithmetic is uint32_t, so >> is a
// logical shift (int32 >> is arithmetic).  The rule and the centre bits come
// from cluster_words.cuh, which the vote-level kernels share.
//
// What bounds it: a frame is about 4 * used bytes read and 5 bytes written
// (1,088 B read at 1080p, where used = 68 * 4), with ~10 integer operations
// per word.  That is far below the card's compute and bandwidth at any batch
// the pipeline sends, so the kernel is bound by launch overhead and memory
// bandwidth, and the end-to-end time is set by host decode.  Design: one warp
// per frame, lanes striding over the frame's words so that neighbouring lanes
// read neighbouring words; the four neighbour words come through the
// read-only cache (__ldg), and a __shfl_down_sync tree sums the warp.  No
// shared memory, no allocation, no synchronisation beyond the warp.

#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_words.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
using mvt::kFullMask;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
word_cluster_kernel(const uint32_t* __restrict__ words, int batch, int gh,
                    int gww, int gw, int y_min, int y_max, int need,
                    int32_t* __restrict__ counts,
                    uint8_t* __restrict__ motion) {
    const int lane = threadIdx.x & 31;
    const int frame = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (frame >= batch) return;  // whole warp leaves together

    const uint32_t* f = words + static_cast<size_t>(frame) * gh * gww;
    const int j_end = min(y_max, gh) * gww;
    uint32_t total = 0;
    for (int j = max(y_min, 0) * gww + lane; j < j_end; j += 32) {
        const int y = j / gww;
        const int c = j - y * gww;
        const uint32_t w = __ldg(f + j);
        const uint32_t prev = c > 0 ? __ldg(f + j - 1) : 0u;
        const uint32_t next = c + 1 < gww ? __ldg(f + j + 1) : 0u;
        const uint32_t up = y > 0 ? __ldg(f + j - gww) : 0u;
        const uint32_t down = y + 1 < gh ? __ldg(f + j + gww) : 0u;
        total += __popc(mvt::cluster_bits(w, prev, next, up, down) &
                        mvt::center_bits(c, gw));
    }
    for (int off = 16; off > 0; off >>= 1)
        total += __shfl_down_sync(kFullMask, total, off);
    if (lane == 0) {
        counts[frame] = static_cast<int32_t>(total);
        motion[frame] = static_cast<int>(total) >= need ? 1 : 0;
    }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// need = max(1, clusters_needed), applied by the caller.
extern "C" int mvt_word_cluster_counts(const void* words, int batch, int gh,
                                       int gww, int gw, int y_min, int y_max,
                                       int need, void* counts, void* motion,
                                       void* stream) {
    if (batch > 0) {
        const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
        word_cluster_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(words), batch, gh, gww, gw, y_min,
            y_max, need, static_cast<int32_t*>(counts),
            static_cast<uint8_t*>(motion));
    }
    return static_cast<int>(cudaGetLastError());
}
