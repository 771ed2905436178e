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
// the vote-level cluster rule (cluster_words.cuh) over the votes at thr, and
// motion[b] = counts[b] >= need and count[b] > 0 (a frame without MV side
// data decides False even at thr = 0).
//
// What bounds it: the payload, 8 bytes an MV, is read once.  At a full
// 1080p list (M = 8192) that is 64 KB of HBM a frame and sets the time; at a
// sparse frame (a few hundred MVs) the per-frame work on the grid does: the
// first design zeroed the 8,160-cell histogram one scalar store at a time
// and walked the 7,316 centre cells with five loads and a division each.
//
// Design: one CTA of 512 threads a frame (256 was slower at sparse and full
// lists, 1024 at sparse ones; PERF.md).  Votes outside rows [y_min,
// y_max) are never kept, so those rows hold vote 0 and read as the rule's
// fill word: the histogram covers the window's rows only (7,440 cells at
// 1080p).  The threads (a) zero that 32-bit histogram with 16-byte stores
// and set the frame's words to those of an all-zero histogram, (b) stride
// over k < count with one 8-byte short4 load an MV, eight in flight a
// thread, consecutive threads on consecutive MVs, and add the kept MVs'
// votes with shared-memory atomicAdd; the vote that lifts a cell to thr also
// sets its bit in K1's row-padded words (an atomicOr in shared memory, once
// a cell), so no pass over the histogram packs it (a ballot pass over it
// instead was 27% slower at sparse lists); (c) run the word rule over the
// words and sum with one block reduction.  No chunking and no padding of M:
// the loop bound is the count.  Counters are 32 bits, so votes never wrap.
// A histogram larger than one block may hold in shared memory (227 KB
// opt-in on the H100: 7680x4320 needs 468 KB) lives in a global scratch
// buffer, one per CTA, the CTAs striding over the frames; its words stay in
// shared memory.  Many MVs in one cell cost nothing extra: full lists with a
// third of the MVs in 48 cells ran as fast as the same count spread evenly.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_words.cuh"
#include "launch.cuh"
#include "mv_keep.cuh"

namespace {

using mvt::hist_shared_bytes;
using mvt::kept_cell;
using mvt::window_lo;
using mvt::window_rows;
using mvt::words_before_hist;

constexpr int kThreads = 512;

// Zeroes p[0, n) with 16-byte stores where p's alignment allows them, the
// threads of the block striding.  p is 4-byte aligned.
__device__ __forceinline__ void zero_cells(int32_t* p, int n) {
    const int misalign = static_cast<int>(
        (reinterpret_cast<uintptr_t>(p) >> 2) & 3);
    const int head = min(n, (4 - misalign) & 3);
    const int quads = (n - head) >> 2;
    const int tail = head + 4 * quads;
    const int tid = threadIdx.x;
    if (tid < head) p[tid] = 0;
    int4* q = reinterpret_cast<int4*>(p + head);
    for (int i = tid; i < quads; i += blockDim.x) q[i] = make_int4(0, 0, 0, 0);
    if (tid < n - tail) p[tail + tid] = 0;
}

__global__ void __launch_bounds__(kThreads)
mv_cluster_kernel(const short4* __restrict__ mvs,
                  const int32_t* __restrict__ mv_counts, int batch, int m,
                  int gh, int gw, int y_min, int y_max, long long bound,
                  int thr, int need, int shift, int32_t* __restrict__ scratch,
                  int32_t* __restrict__ counts,
                  uint8_t* __restrict__ motion) {
    extern __shared__ __align__(16) uint32_t smem[];
    uint32_t* sums = smem;
    uint32_t* words = smem + 32;
    const int y_lo = window_lo(y_min);
    const int rows = window_rows(gh, y_min, y_max);
    const int y_hi = y_lo + rows;
    const int gww = (gw + 31) >> 5;
    const int cells = rows * gw;
    int32_t* hist =
        scratch != nullptr
            ? scratch + static_cast<size_t>(blockIdx.x) * cells
            : reinterpret_cast<int32_t*>(smem + words_before_hist(rows, gw));
    const int tid = threadIdx.x;
    const uint32_t fill = mvt::fill_word(thr);

    for (int b = blockIdx.x; b < batch; b += gridDim.x) {
        zero_cells(hist, cells);
        // the words of an all-zero histogram (bits past gw included, which
        // the rule's centre mask never reads)
        for (int i = tid; i < rows * gww; i += kThreads) words[i] = fill;
        __syncthreads();

        const int count = mv_counts[b];
        const int n = min(max(count, 0), m);
        const short4* f = mvs + static_cast<size_t>(b) * m;
#pragma unroll 8
        for (int k = tid; k < n; k += kThreads) {
            const short4 mv = __ldg(f + k);
            int r, gx;
            if (kept_cell(mv, bound, shift, gw, y_lo, y_hi, r, gx) &&
                atomicAdd(hist + r * gw + gx, 1) + 1 == thr)
                // the vote that lifts a cell to thr sets its bit: a
                // count passes each value below its total once, so the
                // bit ends set exactly when the cell's votes reach
                // thr >= 1
                atomicOr(words + r * gww + (gx >> 5), 1u << (gx & 31));
        }
        __syncthreads();

        uint32_t total = mvt::count_rows(words, y_lo, y_hi, gww, gw, y_lo,
                                         y_hi, fill, tid, kThreads);
        total = mvt::block_sum(total, sums);
        if (tid == 0) {
            counts[b] = static_cast<int32_t>(total);
            motion[b] =
                static_cast<int>(total) >= need && count > 0 ? 1 : 0;
        }
        // the next frame's stores to the histogram, the words and the warp
        // sums each come after a barrier that follows this frame's reads
    }
}

// Lets the kernel take `smem` bytes of dynamic shared memory on `device`,
// asked of the CUDA runtime only when more than it allowed before, so a
// CUDA graph captures launches without the attribute call once eager
// launches at the same shapes have run.
cudaError_t allow_shared(int device, size_t smem) {
    static std::atomic<size_t> allowed[mvt::kMaxDevices];
    const bool cached = device >= 0 && device < mvt::kMaxDevices;
    if (cached && allowed[device].load(std::memory_order_relaxed) >= smem)
        return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        mv_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess && cached)
        allowed[device].store(smem, std::memory_order_relaxed);
    return err;
}

}  // namespace

// The int32 cells of global scratch a launch needs, or -(CUDA error): 0
// when a frame's histogram fits in the shared memory one block of the
// current device may opt in to (227 KB on the H100) and force_global is 0;
// else one histogram of rows [max(y_min, 0), min(y_max, gh)) per CTA, two
// CTAs per SM striding over the frames.
extern "C" long long mvt_mv_cluster_scratch(int batch, int gh, int gw,
                                            int y_min, int y_max,
                                            int force_global) {
    int dev = 0, optin = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    const int rows = window_rows(gh, y_min, y_max);
    if (batch <= 0 ||
        (!force_global &&
         hist_shared_bytes(rows, gw, true) <= static_cast<size_t>(optin)))
        return 0;
    return static_cast<long long>(min(batch, 2 * sms)) * rows * gw;
}

// Launches on `stream` of `device` (made current only where it is not) and
// returns the CUDA error (0 = launched).  With
// scratch == NULL the histograms live in shared memory, one block per frame;
// else scratch holds scratch_cells int32 (mvt_mv_cluster_scratch), one
// histogram per block, and the blocks stride over the frames.  bound is the
// int64 magnitude bound (ceil of the double threshold, so an int32 bound's
// clamp never changes a compare), thr the vote threshold, need = max(1,
// clusters_needed), applied by the caller.
extern "C" int mvt_mv_cluster_counts(const void* mvs, const void* mv_counts,
                                     int batch, int m, int gh, int gw,
                                     int y_min, int y_max, long long bound,
                                     int thr, int need, int shift,
                                     void* scratch, long long scratch_cells,
                                     void* counts, void* motion, int device,
                                     void* stream) {
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    if (batch <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rows = window_rows(gh, y_min, y_max);
    const long long cells = static_cast<long long>(rows) * gw;
    int blocks = batch;
    if (scratch != nullptr && cells > 0) {
        if (scratch_cells < cells)
            return static_cast<int>(cudaErrorInvalidValue);
        const long long fit = scratch_cells / cells;
        blocks = fit < batch ? static_cast<int>(fit) : batch;
    }
    const size_t smem = hist_shared_bytes(rows, gw, scratch == nullptr);
    if (smem > 48 * 1024) {
        const cudaError_t err = allow_shared(device, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    mv_cluster_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const short4*>(mvs),
        static_cast<const int32_t*>(mv_counts), batch, m, gh, gw, y_min,
        y_max, bound, thr, need, shift, static_cast<int32_t*>(scratch),
        static_cast<int32_t*>(counts), static_cast<uint8_t*>(motion));
    return static_cast<int>(cudaGetLastError());
}
