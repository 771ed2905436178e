// Vote-level cluster count for Hopper (sm_90a).
//
// Replaces the TPU kernel mvtrim_tpu/ops/cluster.py:cluster_map_kernel
// (make_cluster_op_pallas), with the threshold as a runtime value, which
// is also the math of cluster_counts_traced that the SAD path ends in.
//
// Input: votes [B, gh, gw], contiguous, uint8 (the grids payload) or int32
// (the SAD block-sum grid).  counts[b] = the centre cells (x in [1, gw-2],
// y in [y_min, y_max)) of frame b with v >= thr and a 4-neighbour >= thr,
// an off-grid neighbour reading as vote 0; motion[b] = counts[b] >= need,
// need = max(1, clusters_needed).
//
// What bounds it: a frame is read once (8,160 B of uint8 at 1080p, 4x that
// as int32) and 5 bytes are written, against a few integer operations a
// word of 32 cells, so HBM bytes bound it at a full batch (B = 2048, 16.7 MB
// of uint8), and launch latency and loads in flight at the SAD path's
// B = 64.  The first design walked each centre cell with five loads and a
// division, one warp a frame, so that walk set the time, and B = 64 filled
// 8 SMs.
//
// Design: one CTA a frame, its size picked from the batch and the SM count
// so that the batch fills the card (8 warps at B = 2048, 32 at B = 64).
// The warps read the rows the centre window touches (its rows and one more
// on each side, inside the grid) as they lie, neighbouring lanes on
// neighbouring cells: four cells a lane (uchar4 / int4 loads) where
// gw % 4 == 0 and the base address allows it, else one (which took about
// twice the time at both batch shapes), with eight rows in flight a warp.
// They pack v >= thr into K1's row-padded words in shared memory
// (cluster_words.cuh: 272 words, 1,088 B at 1080p), and the threads then
// run the word rule over those words, a fill word for rows off the grid, and
// sum with one block reduction.  Nothing crosses CTAs, and nothing is
// allocated.  At B = 2048 the pack's integer work and each CTA's chain of
// load, barrier and reduction still keep it above three times the byte
// bound (PERF.md); at B = 64 one wave of 64 CTAs ends in about 4 us.

#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_words.cuh"
#include "launch.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRows = 8;  // rows a warp reads at once

__device__ __forceinline__ uint32_t nibble4(const uint8_t* p, int thr) {
    const uchar4 q = __ldg(reinterpret_cast<const uchar4*>(p));
    return (static_cast<int>(q.x) >= thr ? 1u : 0u) |
           (static_cast<int>(q.y) >= thr ? 2u : 0u) |
           (static_cast<int>(q.z) >= thr ? 4u : 0u) |
           (static_cast<int>(q.w) >= thr ? 8u : 0u);
}

__device__ __forceinline__ uint32_t nibble4(const int32_t* p, int thr) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    return (q.x >= thr ? 1u : 0u) | (q.y >= thr ? 2u : 0u) |
           (q.z >= thr ? 4u : 0u) | (q.w >= thr ? 8u : 0u);
}

// Rows of the grid whose words the rule reads: the centre window and one
// row on each side, inside [0, gh).
struct Rows {
    int y_lo, y_hi, w_lo, w_hi;
    __host__ __device__ Rows(int gh, int y_min, int y_max) {
        y_lo = y_min > 0 ? y_min : 0;
        y_hi = y_max < gh ? y_max : gh;
        w_lo = y_lo > 0 ? y_lo - 1 : 0;
        w_hi = y_hi + 1 < gh ? y_hi + 1 : gh;
        if (w_hi < w_lo) w_hi = w_lo;
    }
};

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
cluster_map_kernel(const T* __restrict__ votes, int gh, int gw, int y_min,
                   int y_max, int thr, int need,
                   int32_t* __restrict__ counts,
                   uint8_t* __restrict__ motion) {
    extern __shared__ uint32_t smem[];  // 32 warp sums, then the words
    uint32_t* words = smem + 32;
    const int frame = blockIdx.x;
    const int gww = (gw + 31) >> 5;
    const Rows rows(gh, y_min, y_max);
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const T* f = votes + static_cast<size_t>(frame) * gh * gw;

    if constexpr (V == 4) {
        mvt::pack_rows4<kRows>(
            [f, gw, thr](int y, int x) {
                return nibble4(f + y * gw + x, thr);
            },
            words, rows.w_lo, rows.w_hi, gw, gww, warp, warps);
    } else {
        mvt::pack_rows<kRows>(
            [f, gw](int y, int x) {
                return static_cast<int>(__ldg(f + y * gw + x));
            },
            words, rows.w_lo, rows.w_hi, gw, gww, thr, warp, warps);
    }
    __syncthreads();
    uint32_t total = mvt::count_rows(words, rows.w_lo, rows.w_hi, gww, gw,
                                     rows.y_lo, rows.y_hi, mvt::fill_word(thr),
                                     threadIdx.x, blockDim.x);
    total = mvt::block_sum(total, smem);
    if (threadIdx.x == 0) {
        counts[frame] = static_cast<int32_t>(total);
        motion[frame] = static_cast<int>(total) >= need ? 1 : 0;
    }
}

template <typename T, int V>
int launch(const void* votes, int batch, int gh, int gw, int y_min,
           int y_max, int thr, int need, int warps, void* counts,
           void* motion, cudaStream_t stream) {
    const Rows rows(gh, y_min, y_max);
    const size_t smem =
        (32 + static_cast<size_t>(rows.w_hi - rows.w_lo) * ((gw + 31) / 32)) *
        sizeof(uint32_t);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            cluster_map_kernel<T, V>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    cluster_map_kernel<T, V><<<batch, 32 * warps, smem, stream>>>(
        static_cast<const T*>(votes), gh, gw, y_min, y_max, thr, need,
        static_cast<int32_t*>(counts), static_cast<uint8_t*>(motion));
    return static_cast<int>(cudaGetLastError());
}

// Warps a CTA: about 64 warps on each SM across the batch, a power of two
// in [4, 32] (8 at B = 2048 and 32 at B = 64 on 132 SMs).
int warps_for(int batch, int sms) {
    const long long want = (64LL * sms + batch - 1) / batch;
    int warps = 4;
    while (warps < 32 && warps < want) warps <<= 1;
    return warps;
}

template <typename T>
int launch_vec(const void* votes, int batch, int gh, int gw, int y_min,
               int y_max, int thr, int need, int device, void* counts,
               void* motion, cudaStream_t stream) {
    int sms = 0;
    const cudaError_t err =
        mvt::device_attribute<cudaDevAttrMultiProcessorCount>(device, &sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int warps = warps_for(batch, sms);
    // four cells a lane where every row starts on a four-cell boundary
    if (gw % 4 == 0 &&
        reinterpret_cast<uintptr_t>(votes) % (4 * sizeof(T)) == 0)
        return launch<T, 4>(votes, batch, gh, gw, y_min, y_max, thr, need,
                            warps, counts, motion, stream);
    return launch<T, 1>(votes, batch, gh, gw, y_min, y_max, thr, need, warps,
                        counts, motion, stream);
}

}  // namespace

// Launches on `stream` of `device` (made current only where it is not) and
// returns the CUDA error (0 = launched).  is_int32 selects int32 votes, else
// uint8.  need = max(1, clusters_needed), applied by the caller.
extern "C" int mvt_cluster_map_counts(const void* votes, int is_int32,
                                      int batch, int gh, int gw, int y_min,
                                      int y_max, int thr, int need,
                                      void* counts, void* motion, int device,
                                      void* stream) {
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    if (batch <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_int32)
        return launch_vec<int32_t>(votes, batch, gh, gw, y_min, y_max, thr,
                                   need, device, counts, motion, s);
    return launch_vec<uint8_t>(votes, batch, gh, gw, y_min, y_max, thr, need,
                               device, counts, motion, s);
}
