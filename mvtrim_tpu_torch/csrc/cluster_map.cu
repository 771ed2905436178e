// Vote-level cluster count for Hopper (sm_90a).
//
// Replaces the TPU kernel mvtrim_tpu/ops/cluster.py:cluster_map_kernel
// (make_cluster_op_pallas), with the threshold as a runtime value, which
// is also the math of cluster_counts_traced that the SAD path ends in.
//
// Input: votes [B, gh, gw], contiguous, uint8 (the grids payload) or int32
// (the SAD block-sum grid).  counts[b] = the centre cells of frame b that
// the cluster rule of cluster_rule.cuh counts at threshold thr, motion[b] =
// counts[b] >= need, need = max(1, clusters_needed).
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

#include "cluster_rule.cuh"

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
    uint32_t total = count_cluster_cells(
        [f](int i) { return static_cast<int>(__ldg(f + i)); }, gh, gw, y_min,
        y_max, thr, lane, 32);
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
