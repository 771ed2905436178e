// Fused raw-MV vote scatter and cluster count for Hopper (sm_90a).
//
// Replaces the TPU kernels of mvtrim_tpu/ops/mv_vote.py's
// make_mv_cluster_op_pallas: make_kernel (K4, the whole MV list in one
// block) and make_ragged_kernel (K5, the list in chunks, work sized by the
// frame's count), both in one kernel, with the magnitude bound and the vote
// threshold as runtime values so the mv_raw sweep launches it too.
//
// Input: mvs int16 [B, M, 4] (dst_x, dst_y, src_x, src_y), the payload as the
// host decode layer emits it, and mv_counts int32 [B] (0 <= count; the caller
// refuses overflowed, negative counts).  For each frame b, over its MVs
// k < min(count[b], M):
//
//   keep  when  mag >= bound  and  0 <= gx < gw  and  y_min <= gy < y_max
//
// with mag = dx*dx + dy*dy wrapped to int32 as the reference's `int` does
// (|dx| reaches 65535 for int16 fields, so the square is formed in uint32,
// where wrapping is defined, and read back as int32), and gx, gy the
// arithmetic right shifts of dst (floor for a negative dst, which then falls
// off the grid).  Each kept MV adds one vote to cell (gy, gx); counts[b] is
// the cluster rule of cluster_rule.cuh over the votes at thr, and motion[b] =
// counts[b] >= need and count[b] > 0 (a frame without MV side data decides
// False even at thr = 0).
//
// What bounds it: the payload, 8 bytes an MV, is read once; the histogram
// lives in shared memory.  At a full 1080p list (M = 8192) a frame is 64 KB
// of HBM against gh*gw = 8,160 shared-memory cells zeroed and read five times
// by the rule, so the read of the list sets the time; at a sparse frame the
// zeroing and the rule over the grid do.
//
// Design: one CTA of 256 threads per frame.  The threads (a) zero a 32-bit
// histogram of gh*gw votes, (b) stride over k < count with one 8-byte load of
// the MV each, consecutive threads on consecutive MVs, and add the kept MVs'
// votes with shared-memory atomicAdd, (c) run the cluster rule over the
// histogram and sum it with warp shuffles and one word a warp.  No chunking
// and no padding of M: the loop bound is the count.  Counters are 32 bits, so
// votes never wrap.  A grid of more cells than one block may hold in shared
// memory (227 KB opt-in on the H100: 7680x4320 needs 518 KB) runs the same
// kernel with its histograms in a global scratch buffer, one per CTA, the
// CTAs striding over the frames.

#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_rule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
mv_cluster_kernel(const short4* __restrict__ mvs,
                  const int32_t* __restrict__ mv_counts, int batch, int m,
                  int gh, int gw, int y_min, int y_max, long long bound,
                  int thr, int need, int shift, int32_t* __restrict__ scratch,
                  int32_t* __restrict__ counts,
                  uint8_t* __restrict__ motion) {
    extern __shared__ int32_t smem[];
    uint32_t* warp_sums = reinterpret_cast<uint32_t*>(smem);
    const int cells = gh * gw;
    int32_t* hist = scratch != nullptr
                        ? scratch + static_cast<size_t>(blockIdx.x) * cells
                        : smem + kWarps;
    const int tid = threadIdx.x;

    for (int b = blockIdx.x; b < batch; b += gridDim.x) {
        for (int i = tid; i < cells; i += kThreads) hist[i] = 0;
        __syncthreads();

        const int count = mv_counts[b];
        const int n = min(max(count, 0), m);
        const short4* f = mvs + static_cast<size_t>(b) * m;
        for (int k = tid; k < n; k += kThreads) {
            const short4 mv = __ldg(f + k);
            const int dst_x = mv.x, dst_y = mv.y;  // widened before the shift
            const uint32_t dx = static_cast<uint32_t>(dst_x - mv.z);
            const uint32_t dy = static_cast<uint32_t>(dst_y - mv.w);
            const int mag = static_cast<int>(dx * dx + dy * dy);
            const int gx = dst_x >> shift;
            const int gy = dst_y >> shift;
            if (mag >= bound && gx >= 0 && gx < gw && gy >= y_min &&
                gy < y_max)
                atomicAdd(hist + gy * gw + gx, 1);
        }
        __syncthreads();

        uint32_t total = count_cluster_cells(
            [hist](int i) { return hist[i]; }, gh, gw, y_min, y_max, thr,
            tid, kThreads);
        for (int off = 16; off > 0; off >>= 1)
            total += __shfl_down_sync(kFullMask, total, off);
        if ((tid & 31) == 0) warp_sums[tid >> 5] = total;
        __syncthreads();
        if (tid == 0) {
            uint32_t sum = 0;
            for (int w = 0; w < kWarps; ++w) sum += warp_sums[w];
            counts[b] = static_cast<int32_t>(sum);
            motion[b] = static_cast<int>(sum) >= need && count > 0 ? 1 : 0;
        }
        // the next frame zeroes the histogram and the warp sums
        __syncthreads();
    }
}

}  // namespace

// The most dynamic shared memory one block of the current device may opt in
// to, in bytes, or -(CUDA error).
extern "C" int mvt_max_shared_per_block(void) {
    int dev = 0, bytes = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// Launches on `stream` and returns the CUDA error (0 = launched).  With
// scratch == NULL the histogram lives in shared memory, (kWarps + gh*gw) * 4
// bytes a block, one block per frame; else scratch holds scratch_blocks * gh
// * gw int32 and as many blocks stride over the frames.  bound is the int64
// magnitude bound (ceil of the double threshold, so an int32 bound's clamp
// never changes a compare), thr the vote threshold, need = max(1,
// clusters_needed), applied by the caller.
extern "C" int mvt_mv_cluster_counts(const void* mvs, const void* mv_counts,
                                     int batch, int m, int gh, int gw,
                                     int y_min, int y_max, long long bound,
                                     int thr, int need, int shift,
                                     void* scratch, int scratch_blocks,
                                     void* counts, void* motion,
                                     void* stream) {
    if (batch <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int blocks = batch;
    size_t smem = kWarps * sizeof(int32_t);
    if (scratch == nullptr) {
        smem += static_cast<size_t>(gh) * gw * sizeof(int32_t);
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                mv_cluster_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
    } else {
        blocks = min(batch, scratch_blocks);
    }
    mv_cluster_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const short4*>(mvs),
        static_cast<const int32_t*>(mv_counts), batch, m, gh, gw, y_min,
        y_max, bound, thr, need, shift, static_cast<int32_t*>(scratch),
        static_cast<int32_t*>(counts), static_cast<uint8_t*>(motion));
    return static_cast<int>(cudaGetLastError());
}
