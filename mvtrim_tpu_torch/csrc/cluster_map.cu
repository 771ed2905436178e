// Vote-level cluster count for Hopper (sm_90a).
//
// Replaces the TPU kernel mvtrim_tpu/ops/cluster.py:cluster_map_kernel
// (make_cluster_op_pallas), with the threshold as a runtime value, which
// is also the math of cluster_counts_traced that the SAD path ends in.
//
// Input: votes [B, gh, gw], contiguous, uint8 (the grids payload) or int32
// (the SAD block-sum grid).  For each centre cell, y in [y_min, y_max) and
// x in [1, gw-2]:
//
//   counts  when  min(v, max(left, right, up, down)) >= thr
//
// which is "v >= thr and some 4-neighbour >= thr".  A neighbour outside the
// grid reads as vote 0 and is compared with thr like any other cell, so at
// thr <= 0 it is active (what _shift2d's zero fill and the NumPy oracle do).
// Left and right of a centre cell always lie in the grid; up and down may
// not when the vertical margin is 0.  counts[b] = number of such cells,
// motion[b] = counts[b] >= need, need = max(1, clusters_needed).
//
// What bounds it: a frame is gh*gw elements read once (8,160 B of uint8 at
// 1080p; 4x that as int32) and 5 bytes written, but each cell costs five
// loads (mostly L1 hits) and an integer division, so the warp's serial walk
// over its frame's cells, not HBM, sets the time; with one warp per frame a
// small batch (the SAD path's 64 frames) fills few SMs.  Design: one warp
// per frame, lanes
// striding over the centre cells in row order, so neighbouring lanes read
// neighbouring elements; the four neighbours come through the read-only
// cache (__ldg) and mostly hit in L1; a __shfl_down_sync tree sums the
// warp.  No shared memory, no allocation, no synchronisation beyond the
// warp.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cluster_map_kernel(const T* __restrict__ votes, int batch, int gh, int gw,
                   int y_min, int y_max, int thr, int need,
                   int32_t* __restrict__ counts,
                   uint8_t* __restrict__ motion) {
    const int lane = threadIdx.x & 31;
    const int frame = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (frame >= batch) return;  // whole warp leaves together

    const T* f = votes + static_cast<size_t>(frame) * gh * gw;
    const int y0 = max(y_min, 0);
    const int rows = min(y_max, gh) - y0;
    const int cols = gw - 2;  // centre columns x = 1 .. gw-2
    const int cells = rows > 0 && cols > 0 ? rows * cols : 0;
    uint32_t total = 0;
    for (int j = lane; j < cells; j += 32) {
        const int y = y0 + j / cols;
        const int x = 1 + j % cols;
        const int i = y * gw + x;
        const int v = static_cast<int>(__ldg(f + i));
        const int left = static_cast<int>(__ldg(f + i - 1));
        const int right = static_cast<int>(__ldg(f + i + 1));
        const int up = y > 0 ? static_cast<int>(__ldg(f + i - gw)) : 0;
        const int down = y + 1 < gh ? static_cast<int>(__ldg(f + i + gw)) : 0;
        const int nmax = max(max(left, right), max(up, down));
        total += min(v, nmax) >= thr ? 1u : 0u;
    }
    for (int off = 16; off > 0; off >>= 1)
        total += __shfl_down_sync(kFullMask, total, off);
    if (lane == 0) {
        counts[frame] = static_cast<int32_t>(total);
        motion[frame] = static_cast<int>(total) >= need ? 1 : 0;
    }
}

template <typename T>
void launch(const void* votes, int batch, int gh, int gw, int y_min,
            int y_max, int thr, int need, void* counts, void* motion,
            cudaStream_t stream) {
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cluster_map_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
        static_cast<const T*>(votes), batch, gh, gw, y_min, y_max, thr, need,
        static_cast<int32_t*>(counts), static_cast<uint8_t*>(motion));
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// is_int32 selects int32 votes, else uint8.  need = max(1,
// clusters_needed), applied by the caller.
extern "C" int mvt_cluster_map_counts(const void* votes, int is_int32,
                                      int batch, int gh, int gw, int y_min,
                                      int y_max, int thr, int need,
                                      void* counts, void* motion,
                                      void* stream) {
    if (batch > 0) {
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (is_int32)
            launch<int32_t>(votes, batch, gh, gw, y_min, y_max, thr, need,
                            counts, motion, s);
        else
            launch<uint8_t>(votes, batch, gh, gw, y_min, y_max, thr, need,
                            counts, motion, s);
    }
    return static_cast<int>(cudaGetLastError());
}
