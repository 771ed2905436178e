// The bench's controls for Hopper (sm_90a).  C1, C2 and C6-C8 keep a
// product kernel's launch (grid, CTA shape, frames a CTA, load width), read
// every byte the product kernel reads and do trivial, integer-exact
// arithmetic on it: their time is the practical memory ceiling of that
// launch on the card.  C3 and C9 read K4+K5's ragged payload on a launch of
// their own, made for this card: what the card can stream of it, and what
// it can scatter of it.  C10 runs the one-hot vote
// product's shapes on the tensor cores.  The bench
// (mvtrim_tpu_torch/bench/) holds the product kernels to them, beside the
// bound.  Nothing on the scan paths calls them.
//
// C1 mvt_word_stream_control replaces the TPU kernel bench.py's
// build_control_sweep_T (benchmarks/word_bench.py's tctrl) and follows K1
// (word_cluster.cu): F frames a CTA as word_cluster.cu's entry point picks
// them, the CTA's span brought into shared memory by the same loader
// (frame_span.cuh: one TMA bulk copy, plain loads for the unaligned head and
// tail, no byte past the span), or device-memory reads for a frame larger
// than a block's shared memory.  Each warp sums (w & 1) over its frame's
// words in K1's word view (word c of row y = bytes 4c..4c+3, little-endian,
// a byte at or past the pitch reading 0), over all gh rows:
//   sums[b] = sum over y < gh, c < ceil(gw / 32) of rows[b, y, 4c] & 1.
// On the words payload that is the TPU control's per-frame count of one
// pass; on the bits payload, that count over repack_bits_words(bits).
//
// C2 mvt_sad_stream_control replaces sad_bench.py's ctrl / ctrlf<F> and
// follows K6 (sad_block.cu): one CTA per (frame, block row), frames on grid
// x, VEC-byte loads (16, 4 or 1, the caller's choice as for K6), both planes
// read as K6 reads them.  It writes K6's grid int32 [B, gh, gw]:
//   grid[b, by, bx] = sum over the block's pixels of (luma[b + 1] & 1)
//                     + (b == 0 ? (luma[0] & 1) : 0),
// so a frame's grid sum is ctrlf<B>'s count (the carry's bits on a block's
// first frame, one block of B frames).  The carry's bits of frames b > 0 are
// loaded and masked to zero, so every CTA reads both planes.
//
// C3 mvt_mv_stream_control replaces mv_bench.py:469's ctrl as K4+K5 reads
// the payload, by the count:
//   sums[b] = count[b] + sum over k < clamp(count[b], 0, M) of
//             dst_x + dst_y + src_x + src_y,
// widened to 32 bits and wrapped mod 2^32 (mv_bench.py's ctrl at full counts
// only).  C9 mvt_mv_votes_control replaces mv_bench.py:469's noclu: every
// MV K4+K5's keep rule keeps (mv_keep.cuh) adds one vote to its cell of a
// 32-bit histogram in shared memory, and
//   sums[b] = the kept MVs of frame b (the sum of its votes).
// What bounds them: the live rows, 8 bytes an MV, read once (14.9 MB at
// 1080p, M = 8192, B = 2048, counts log-uniform in 1..M: 4.4 us at 3.35
// TB/s).  On K4+K5's launch (one 512-thread CTA a frame, 2048 CTAs, about
// four waves) they reached 23% (C9) and 32% (C3) of that: at sparse counts
// most of a CTA's threads issued no load, and each CTA paid a DRAM round
// trip, a block reduction and its start; C9 also zeroed the 7,440-cell
// histogram each frame.  Here a frame goes to a small CTA (C3 128 threads;
// C9 256, with the frame's histogram, or 512 where the histogram passes 48
// KB), and a persistent grid of as many CTAs as the card holds takes the
// frames in turn, so a sparse batch is one wave of CTAs whose threads
// mostly load.  Units of two MVs are read by 16-byte loads (8-byte ones
// for an odd M or a payload 8 bytes off a 16-byte boundary), eight (C3) or
// four (C9) a thread issued before any is used.  Each frame's result is
// one CTA's, stored once: no atomics across CTAs, nothing to zero first.
// C9 zeroes its histogram once a launch, and after each frame clears only
// the cells its threads hit, from the indices they still hold (all cells
// where the frame took more than one pass).  A frame with more MVs than a
// CTA's pass (C3: 2,048; C9: 2,048 at 1080p) takes several passes of the
// same CTA, which sets the tail at counts near M.  A histogram past a
// block's shared memory (7680x4320 at the default BLOCK_SHIFT 4: 468 KB)
// takes a global scratch histogram a CTA.  A launch that split the rows
// themselves evenly over the grid (a scan of the counts in each CTA,
// atomics into zeroed sums) measured slower at these batches: its fixed
// part cost more than the balance saved (PERF.md).
//
// C6-C8 mvt_mv_capacity_control replace mv_bench.py's ctrl, ctrlsub and
// ctrlmm on K4+K5's launch (one 512-thread CTA a frame, one 8-byte short4
// load an MV, eight in flight a thread) with the loop bound M, not the
// count, since the TPU controls read every slot.  The payload ships M slots
// a frame whatever the count, so C6 against C3 is what reading by capacity
// costs.
//   C6 (ctrl)     sums[b] = count[b] + sum over k < M of the four fields;
//   C7 (ctrlsub)  C6 + sum over k < M of sub[b, k], a second copy of dst_x
//                 (int16 [B, M]) that the caller fills; on the TPU it was a
//                 sublane-major [M, 1] stream, here it is contiguous and
//                 read by consecutive threads, so no layout is imitated;
//   C8 (ctrlmm)   count[b] + sum over k < M of (v & 255) of each field.
// All widened to 32 bits and wrapped mod 2^32.  The TPU's ctrlmm summed by
// a bf16 ones-matmul to keep the vector unit idle; here a mask and an add
// a field is already the least, so C8 uses no tensor core.
//
// C10 mvt_mv_matrix_control replaces mv_bench.py's mmctrl: the shapes of
// the TPU's one-hot vote product on the tensor cores, with the operands
// reduced to parity bits.  Per frame, over all M slots,
//   a_k = (dst_x ^ src_x) & 1,  b_k = (dst_y ^ src_y) & 1,
// the product of the [gw_p x M] matrix whose rows are all a with the
// [M x gh_p] matrix whose columns are all b, summed over its gw_p x gh_p
// cells and wrapped to int32: gh_p * gw_p * sum_k a_k b_k.  Integer on
// the tensor cores (mma.sync m16n8k32, s8 x s8 -> s32), never TF32; exact,
// each cell is at most M.
//
// What bounds them: C1-C3 and C6-C9 bytes, as their product kernels at
// those launches (the arithmetic is a mask, an add or a popcount a load;
// C9's keep rule and atomic about 12 integer operations an MV); C10 the
// tensor cores' int8 rate (2 gh_p gw_p M B operations against
// 8 M B bytes).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "cluster_words.cuh"
#include "frame_span.cuh"
#include "launch.cuh"
#include "mv_keep.cuh"

namespace {

using mvt::kFullMask;
using mvt::kMaxFrames;

constexpr uint32_t kBit0 = 0x01010101u;  // bit 0 of each byte of a word

// --- C1: K1's launch ---

// The warp's sum of (word & 1) over all gh rows of the frame whose row y
// starts at byte base + y * pitch of src (in lane 0), K1's walk: lane l
// takes word column l % gww of band l / gww of the rows.
template <class Src>
__device__ __forceinline__ uint32_t bit0_frame(const Src& src, int base,
                                               int gh, int pitch, int gww) {
    const int lane = threadIdx.x & 31;
    const int bands = gww <= 32 ? 32 / gww : 1;
    const int band = gww <= 32 ? lane / gww : 0;
    const int len = (gh + bands - 1) / bands;
    const int y0 = band * len;
    const int y1 = min(y0 + len, gh);
    uint32_t total = 0;
    if (band < bands && y0 < y1) {
        for (int c = gww <= 32 ? lane % gww : lane; c < gww; c += 32) {
            const int avail = pitch - 4 * c;  // >= 1: 4 (gww - 1) < pitch
            int o = base + y0 * pitch + 4 * c;
            for (int y = y0; y < y1; ++y, o += pitch)
                total += src.word(o, avail) & 1u;
        }
    }
    for (int off = 16; off > 0; off >>= 1)
        total += __shfl_down_sync(kFullMask, total, off);
    return total;
}

template <bool kShared, bool kAligned>
__global__ void __launch_bounds__(32 * kMaxFrames)
word_stream_control_kernel(const uint8_t* __restrict__ rows, int batch,
                           int gh, int pitch, int gww,
                           int32_t* __restrict__ sums) {
    const int frames = blockDim.x >> 5;
    const int f0 = blockIdx.x * frames;
    const int nf = min(frames, batch - f0);
    const int k = threadIdx.x >> 5;
    const long long frame_bytes = static_cast<long long>(gh) * pitch;
    uint32_t total;
    if constexpr (!kShared) {
        if (k >= nf) return;
        const mvt::GlobalFrame src{rows + (f0 + k) * frame_bytes};
        total = bit0_frame(src, 0, gh, pitch, gww);
    } else {
        extern __shared__ __align__(16) uint8_t smem[];
        uint64_t* barrier = reinterpret_cast<uint64_t*>(smem);
        uint8_t* data = smem + mvt::kBarrierBytes;
        const uint8_t* span = rows + f0 * frame_bytes;
        const int len = static_cast<int>(nf * frame_bytes);
        const int head = mvt::load_span(span, len, data, barrier);
        __syncthreads();
        if (k >= nf) return;  // warp 0, which issued the copy, stays
        mvt::wait_phase0(barrier);
        const mvt::SharedSpan<kAligned> src{
            reinterpret_cast<const uint32_t*>(data), data, head};
        total = bit0_frame(src, static_cast<int>(k * frame_bytes), gh, pitch,
                           gww);
    }
    if ((threadIdx.x & 31) == 0) sums[f0 + k] = static_cast<int32_t>(total);
}

template <bool kAligned>
cudaError_t allow_word_shared(int device, int optin) {
    static std::atomic<bool> done[mvt::kMaxDevices];
    const bool cached = device >= 0 && device < mvt::kMaxDevices;
    if (cached && done[device].load(std::memory_order_relaxed))
        return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        word_stream_control_kernel<true, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess && cached)
        done[device].store(true, std::memory_order_relaxed);
    return err;
}

template <bool kShared, bool kAligned>
int launch_word(const uint8_t* rows, int batch, int gh, int pitch, int gww,
                const mvt::SpanLaunch& span, int device, int optin,
                int32_t* sums, cudaStream_t stream) {
    if (span.smem > 48 * 1024) {
        const cudaError_t err = allow_word_shared<kAligned>(device, optin);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    word_stream_control_kernel<kShared, kAligned>
        <<<(batch + span.frames - 1) / span.frames, 32 * span.frames,
           static_cast<size_t>(span.smem), stream>>>(rows, batch, gh, pitch,
                                                     gww, sums);
    return static_cast<int>(cudaGetLastError());
}

// --- C2: K6's launch ---

// bit-0 count of VEC bytes at cur, plus that of prev under `carry` (kBit0
// or 0), both loaded as K6 loads them.
template <int VEC>
__device__ __forceinline__ uint32_t unit_bits(const uint8_t* cur,
                                              const uint8_t* prev,
                                              uint32_t carry, uint32_t acc);

template <>
__device__ __forceinline__ uint32_t unit_bits<16>(const uint8_t* cur,
                                                  const uint8_t* prev,
                                                  uint32_t carry,
                                                  uint32_t acc) {
    const uint4 c = __ldg(reinterpret_cast<const uint4*>(cur));
    const uint4 p = __ldg(reinterpret_cast<const uint4*>(prev));
    acc += __popc(c.x & kBit0) + __popc(c.y & kBit0) + __popc(c.z & kBit0) +
           __popc(c.w & kBit0);
    return acc + __popc(p.x & carry) + __popc(p.y & carry) +
           __popc(p.z & carry) + __popc(p.w & carry);
}

template <>
__device__ __forceinline__ uint32_t unit_bits<4>(const uint8_t* cur,
                                                 const uint8_t* prev,
                                                 uint32_t carry,
                                                 uint32_t acc) {
    const uint32_t c = __ldg(reinterpret_cast<const uint32_t*>(cur));
    const uint32_t p = __ldg(reinterpret_cast<const uint32_t*>(prev));
    return acc + __popc(c & kBit0) + __popc(p & carry);
}

template <>
__device__ __forceinline__ uint32_t unit_bits<1>(const uint8_t* cur,
                                                 const uint8_t* prev,
                                                 uint32_t carry,
                                                 uint32_t acc) {
    return acc + (__ldg(cur) & 1u) + (__ldg(prev) & carry & 1u);
}

template <int VEC>
__global__ void __launch_bounds__(256)
sad_stream_control_kernel(const uint8_t* __restrict__ luma, int height,
                          int width, int block, int gh, int gw,
                          int32_t* __restrict__ grid) {
    const int b = blockIdx.x;   // output frame: cur = b + 1, prev = b
    const int by = blockIdx.y;  // block row
    const size_t plane = static_cast<size_t>(height) * width;
    const uint8_t* prev = luma + static_cast<size_t>(b) * plane;
    const uint8_t* cur = prev + plane;
    const uint32_t carry = b == 0 ? kBit0 : 0u;
    const int r0 = by * block;
    const int r1 = min(r0 + block, height);
    const int tpb = block / VEC;  // threads per block column, divides 32
    const int units = (width + VEC - 1) / VEC;
    int32_t* out = grid + (static_cast<size_t>(b) * gh + by) * gw;

    for (int base = 0; base < units; base += blockDim.x) {
        const int u = base + threadIdx.x;
        uint32_t sum = 0;
        if (u < units) {
            const size_t x = static_cast<size_t>(u) * VEC;
#pragma unroll 4
            for (int r = r0; r < r1; ++r) {
                const size_t off = static_cast<size_t>(r) * width + x;
                sum = unit_bits<VEC>(cur + off, prev + off, carry, sum);
            }
        }
        for (int d = tpb / 2; d > 0; d >>= 1)
            sum += __shfl_down_sync(kFullMask, sum, d, tpb);
        if (u < units && u % tpb == 0)
            out[u / tpb] = static_cast<int32_t>(sum);
    }
}

template <int VEC>
void launch_sad(const void* luma, int batch, int height, int width,
                int block, int gh, int gw, void* grid, cudaStream_t stream) {
    const int units = (width + VEC - 1) / VEC;
    const int threads = std::min(256, (units + 31) / 32 * 32);
    sad_stream_control_kernel<VEC><<<dim3(batch, gh), threads, 0, stream>>>(
        static_cast<const uint8_t*>(luma), height, width, block, gh, gw,
        static_cast<int32_t*>(grid));
}

// --- C3 and C9: the ragged payload, a frame to a small CTA ---

// C3's CTA and its loads a thread before it uses any; C9's CTA where a
// histogram of at most kNarrowHistBytes leaves room for several CTAs an
// SM, else kWideThreads, and its loads a thread.
constexpr int kStreamThreads = 128;
constexpr int kStreamUnroll = 8;
constexpr int kVotesThreads = 256;
constexpr int kWideThreads = 512;
constexpr int kVotesUnroll = 4;
constexpr int kNarrowHistBytes = 48 * 1024;

// A frame's live rows as units: two MVs (16 bytes) when M is even and the
// payload 16-byte aligned, else one (8 bytes).
template <int kRows>
using Unit = typename std::conditional<kRows == 2, int4, uint2>::type;

// An MV from the two 32-bit words of its 8 bytes (little-endian fields).
__device__ __forceinline__ short4 words_mv(uint32_t lo, uint32_t hi) {
    return make_short4(static_cast<short>(lo & 0xffffu),
                       static_cast<short>(lo >> 16),
                       static_cast<short>(hi & 0xffffu),
                       static_cast<short>(hi >> 16));
}

// Unit k's first and second MV; the second is live while 2k + 1 < n.
template <int kRows>
__device__ __forceinline__ short4 first_mv(const Unit<kRows>& u) {
    return words_mv(static_cast<uint32_t>(u.x), static_cast<uint32_t>(u.y));
}
__device__ __forceinline__ short4 second_mv(const int4& u) {
    return words_mv(static_cast<uint32_t>(u.z), static_cast<uint32_t>(u.w));
}

__device__ __forceinline__ uint32_t field_sum(short4 mv) {
    return static_cast<uint32_t>(static_cast<int>(mv.x) + mv.y + mv.z +
                                 mv.w);
}

// C3.  The CTAs take the frames in turn; a frame's units are strided over
// the CTA's threads, kStreamUnroll loads a thread issued before any is used.
template <int kRows>
__global__ void __launch_bounds__(kStreamThreads)
mv_stream_control_kernel(const short4* __restrict__ mvs,
                         const int32_t* __restrict__ mv_counts, int batch,
                         int m, int32_t* __restrict__ sums) {
    __shared__ uint32_t warp_sums[32];
    for (int f = blockIdx.x; f < batch; f += gridDim.x) {
        const int count = mv_counts[f];
        const int n = min(max(count, 0), m);
        const int units = (n + kRows - 1) / kRows;
        const Unit<kRows>* src = reinterpret_cast<const Unit<kRows>*>(
            mvs + static_cast<size_t>(f) * m);
        uint32_t total = 0;
        for (int k0 = threadIdx.x; k0 < units;
             k0 += kStreamThreads * kStreamUnroll) {
            Unit<kRows> u[kStreamUnroll];
#pragma unroll
            for (int j = 0; j < kStreamUnroll; ++j) {
                const int k = k0 + j * kStreamThreads;
                u[j] = __ldg(src + (k < units ? k : 0));
            }
#pragma unroll
            for (int j = 0; j < kStreamUnroll; ++j) {
                const int k = k0 + j * kStreamThreads;
                if (k >= units) continue;
                total += field_sum(first_mv<kRows>(u[j]));
                if constexpr (kRows == 2)
                    if (2 * k + 1 < n) total += field_sum(second_mv(u[j]));
            }
        }
        // block_sum's barrier also keeps the next frame's warp sums apart
        total = mvt::block_sum(total, warp_sums);
        if (threadIdx.x == 0)
            sums[f] =
                static_cast<int32_t>(total + static_cast<uint32_t>(count));
        __syncthreads();
    }
}

// C9.  The CTAs take the frames in turn, each CTA with one 32-bit histogram
// of the window's rows x gw cells (in shared memory after its warp sums, or
// a global scratch of `stride` cells a CTA), zeroed once.  Each kept MV of
// the frame adds one vote to its cell; a barrier (here the frame's votes
// are whole, where K4+K5's rule would read them); then the cells are
// cleared: those the threads hit, from the indices they still hold, when
// the frame took one pass, else all of them.
template <int kRows, bool kShared, int kThreads>
__global__ void __launch_bounds__(kThreads)
mv_votes_control_kernel(const short4* __restrict__ mvs,
                        const int32_t* __restrict__ mv_counts, int batch,
                        int m, int gh, int gw, int y_min, int y_max,
                        long long bound, int shift,
                        int32_t* __restrict__ scratch, int stride,
                        int32_t* __restrict__ kept) {
    // (uint8_t, as the other kernels of this file declare it)
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t* warp_sums = reinterpret_cast<uint32_t*>(smem);
    int32_t* hist =
        kShared ? reinterpret_cast<int32_t*>(smem + 32 * 4)
                : scratch + static_cast<size_t>(blockIdx.x) * stride;
    const int y_lo = mvt::window_lo(y_min);
    const int y_hi = y_lo + mvt::window_rows(gh, y_min, y_max);
    int4* quads = reinterpret_cast<int4*>(hist);
    for (int i = threadIdx.x; i < stride >> 2; i += kThreads)
        quads[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    for (int f = blockIdx.x; f < batch; f += gridDim.x) {
        const int n = min(max(mv_counts[f], 0), m);
        const int units = (n + kRows - 1) / kRows;
        const Unit<kRows>* src = reinterpret_cast<const Unit<kRows>*>(
            mvs + static_cast<size_t>(f) * m);
        uint32_t total = 0;
        int cell[kVotesUnroll][2];
#pragma unroll
        for (int j = 0; j < kVotesUnroll; ++j) cell[j][0] = cell[j][1] = -1;
        for (int k0 = threadIdx.x; k0 < units;
             k0 += kThreads * kVotesUnroll) {
            Unit<kRows> u[kVotesUnroll];
#pragma unroll
            for (int j = 0; j < kVotesUnroll; ++j) {
                const int k = k0 + j * kThreads;
                u[j] = __ldg(src + (k < units ? k : 0));
            }
#pragma unroll
            for (int j = 0; j < kVotesUnroll; ++j) {
                const int k = k0 + j * kThreads;
                int r, gx;
                cell[j][0] = cell[j][1] = -1;
                if (k < units &&
                    mvt::kept_cell(first_mv<kRows>(u[j]), bound, shift, gw,
                                   y_lo, y_hi, r, gx))
                    cell[j][0] = r * gw + gx;
                if constexpr (kRows == 2)
                    if (k < units && 2 * k + 1 < n &&
                        mvt::kept_cell(second_mv(u[j]), bound, shift, gw,
                                       y_lo, y_hi, r, gx))
                        cell[j][1] = r * gw + gx;
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    if (cell[j][h] >= 0) {
                        atomicAdd(hist + cell[j][h], 1);
                        ++total;
                    }
            }
        }
        // block_sum's barrier follows every thread's votes
        total = mvt::block_sum(total, warp_sums);
        if (threadIdx.x == 0) kept[f] = static_cast<int32_t>(total);
        if (units <= kThreads * kVotesUnroll) {
#pragma unroll
            for (int j = 0; j < kVotesUnroll; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    if (cell[j][h] >= 0) hist[cell[j][h]] = 0;
        } else {
            for (int i = threadIdx.x; i < stride >> 2; i += kThreads)
                quads[i] = make_int4(0, 0, 0, 0);
        }
        __syncthreads();  // cleared before the next frame's votes
    }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on `device` and
// returns how many of its CTAs of `threads` an SM holds: asked of the CUDA
// runtime only for a size not asked before (the last one cached a device
// and kTag, one tag a kernel), so a CUDA graph captures launches without
// those calls once eager launches at the same shapes have run.
template <int kTag>
cudaError_t ctas_per_sm(const void* kernel, int threads, int device,
                        size_t smem, int* ctas) {
    static std::atomic<long long> cached[mvt::kMaxDevices];  // smem << 8 | n
    const bool cache = device >= 0 && device < mvt::kMaxDevices;
    if (cache) {
        const long long v = cached[device].load(std::memory_order_relaxed);
        if (v != 0 && static_cast<size_t>(v >> 8) == smem) {
            *ctas = static_cast<int>(v & 255);
            return cudaSuccess;
        }
    }
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                            threads, smem);
    if (err == cudaSuccess && *ctas < 1) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess && cache)
        cached[device].store(static_cast<long long>(smem) << 8 | *ctas,
                             std::memory_order_relaxed);
    return err;
}

// A persistent grid of `kernel`: every CTA the card holds at once, at most
// one a frame.
template <int kTag>
cudaError_t persistent_grid(const void* kernel, int threads, int device,
                            size_t smem, int batch, int* blocks) {
    int sms = 0, ctas = 0;
    cudaError_t err =
        mvt::device_attribute<cudaDevAttrMultiProcessorCount>(device, &sms);
    if (err == cudaSuccess)
        err = ctas_per_sm<kTag>(kernel, threads, device, smem, &ctas);
    *blocks = std::min(batch, sms * ctas);
    return err;
}

template <int kRows>
int launch_stream(const void* mvs, const void* mv_counts, int batch, int m,
                  void* sums, int device, cudaStream_t s) {
    int blocks = 0;
    const cudaError_t err = persistent_grid<kRows - 1>(
        reinterpret_cast<const void*>(&mv_stream_control_kernel<kRows>),
        kStreamThreads, device, 0, batch, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    mv_stream_control_kernel<kRows><<<blocks, kStreamThreads, 0, s>>>(
        static_cast<const short4*>(mvs),
        static_cast<const int32_t*>(mv_counts), batch, m,
        static_cast<int32_t*>(sums));
    return static_cast<int>(cudaGetLastError());
}

// The histogram's cells a CTA, rounded up to 16 bytes.
int votes_stride(int gh, int gw, int y_min, int y_max) {
    return (mvt::window_rows(gh, y_min, y_max) * gw + 3) & ~3;
}

// C9's dynamic shared memory: the warp sums, then the histogram.
size_t votes_smem(int stride, bool shared) {
    return 32 * 4 + (shared ? static_cast<size_t>(stride) * 4 : 0);
}

template <int kRows, bool kShared, int kThreads>
int launch_votes(const void* mvs, const void* mv_counts, int batch, int m,
                 int gh, int gw, int y_min, int y_max, long long bound,
                 int shift, void* scratch, long long scratch_cells,
                 void* kept, int device, cudaStream_t s) {
    const int stride = votes_stride(gh, gw, y_min, y_max);
    const size_t smem = votes_smem(stride, kShared);
    int blocks = 0;
    const cudaError_t err =
        persistent_grid<2 + (kRows - 1) + 2 * kShared + 4 * (kThreads != 512)>(
            reinterpret_cast<const void*>(
                &mv_votes_control_kernel<kRows, kShared, kThreads>),
            kThreads, device, smem, batch, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!kShared) {
        // one histogram of scratch a CTA
        const long long fit = scratch_cells / stride;
        if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
        blocks = static_cast<int>(std::min<long long>(fit, blocks));
    }
    mv_votes_control_kernel<kRows, kShared, kThreads>
        <<<blocks, kThreads, smem, s>>>(
            static_cast<const short4*>(mvs),
            static_cast<const int32_t*>(mv_counts), batch, m, gh, gw, y_min,
            y_max, bound, shift, static_cast<int32_t*>(scratch), stride,
            static_cast<int32_t*>(kept));
    return static_cast<int>(cudaGetLastError());
}

// C9's launch for the histogram's place and size.
template <int kRows>
int launch_votes_for(const void* mvs, const void* mv_counts, int batch,
                     int m, int gh, int gw, int y_min, int y_max,
                     long long bound, int shift, void* scratch,
                     long long scratch_cells, void* kept, int device,
                     cudaStream_t s) {
    const int stride = votes_stride(gh, gw, y_min, y_max);
    if (scratch != nullptr && stride > 0)
        return launch_votes<kRows, false, kWideThreads>(
            mvs, mv_counts, batch, m, gh, gw, y_min, y_max, bound, shift,
            scratch, scratch_cells, kept, device, s);
    if (static_cast<size_t>(stride) * 4 <= kNarrowHistBytes)
        return launch_votes<kRows, true, kVotesThreads>(
            mvs, mv_counts, batch, m, gh, gw, y_min, y_max, bound, shift,
            nullptr, 0, kept, device, s);
    return launch_votes<kRows, true, kWideThreads>(
        mvs, mv_counts, batch, m, gh, gw, y_min, y_max, bound, shift,
        nullptr, 0, kept, device, s);
}

// Whether the payload may be read a 16-byte unit (two MVs) at a time.
bool in_pairs(const void* mvs, int m) {
    return m % 2 == 0 && reinterpret_cast<uintptr_t>(mvs) % 16 == 0;
}

// --- C6, C7, C8: K4+K5's launch over all M slots ---

constexpr int kMvThreads = 512;

enum class Capacity { kSum, kSub, kLowBytes };  // C6, C7, C8

template <Capacity kMode>
__global__ void __launch_bounds__(kMvThreads)
mv_capacity_control_kernel(const short4* __restrict__ mvs,
                           const int32_t* __restrict__ mv_counts,
                           const int16_t* __restrict__ sub, int m,
                           int32_t* __restrict__ sums) {
    __shared__ uint32_t warp_sums[32];
    const int b = blockIdx.x;
    const short4* f = mvs + static_cast<size_t>(b) * m;
    uint32_t total = 0;
#pragma unroll 8
    for (int k = threadIdx.x; k < m; k += kMvThreads) {
        const short4 mv = __ldg(f + k);
        if constexpr (kMode == Capacity::kLowBytes)
            total += static_cast<uint32_t>((mv.x & 255) + (mv.y & 255) +
                                           (mv.z & 255) + (mv.w & 255));
        else
            total += static_cast<uint32_t>(static_cast<int>(mv.x) + mv.y +
                                           mv.z + mv.w);
        if constexpr (kMode == Capacity::kSub)
            total += static_cast<uint32_t>(static_cast<int>(
                __ldg(sub + static_cast<size_t>(b) * m + k)));
    }
    total = mvt::block_sum(total, warp_sums);
    if (threadIdx.x == 0)
        sums[b] = static_cast<int32_t>(
            total + static_cast<uint32_t>(mv_counts[b]));
}

// --- C10: the vote product's shapes on the tensor cores ---

// A CTA a frame of kMatrixWarps warps; warp w takes the frame's k-steps of
// 32 slots w, w + kMatrixWarps, ...  Each lane loads one MV of the step
// (consecutive lanes on consecutive MVs), two ballots gather the step's
// 32 a and 32 b bits, and each thread expands the bits at its own k
// positions into the s8 fragments: every row of A is a and every column of
// B is b, so one fragment pair serves every output tile.  The warp then
// issues an mma for every one of the gw_p / 16 x gh_p / 8 tiles of the
// output, into kMatrixAcc accumulators in turn (independent chains to
// hide the mma's latency); the accumulators' sum over the CTA is the sum
// of the output's cells.
constexpr int kMatrixWarps = 4;
constexpr int kMatrixAcc = 8;

// Four bits -> four bytes of 0 or 1, bit i in byte i (element i of an s8
// fragment register is its byte i).
__device__ __forceinline__ uint32_t bit_bytes(uint32_t bits, int shift) {
    return (((bits >> shift) & 15u) * 0x00204081u) & 0x01010101u;
}

// c += A (16 x 32, every row the k-vector a) x B (32 x 8, every column b):
// a thread holds elements k = 4t..4t+3 (lo) and 16+4t..16+4t+3 (hi) of
// both, t = lane % 4; A's registers 0 and 1 (rows g and g + 8) are the
// same, as are 2 and 3.
__device__ __forceinline__ void mma_parity(int (&c)[4], uint32_t a_lo,
                                           uint32_t a_hi, uint32_t b_lo,
                                           uint32_t b_hi) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a_lo), "r"(a_lo), "r"(a_hi), "r"(a_hi), "r"(b_lo),
          "r"(b_hi));
}

// One MV of a k-step, zeros past M.
__device__ __forceinline__ short4 step_mv(const short4* f, int step, int m) {
    const int k = step * 32 + (threadIdx.x & 31);
    return k < m ? __ldg(f + k) : make_short4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(32 * kMatrixWarps)
mv_matrix_control_kernel(const short4* __restrict__ mvs, int m,
                         int tile_groups, int32_t* __restrict__ sums) {
    __shared__ uint32_t warp_sums[32];
    const short4* f = mvs + static_cast<size_t>(blockIdx.x) * m;
    const int t4 = (threadIdx.x & 3) * 4;
    const int steps = (m + 31) >> 5;
    int acc[kMatrixAcc][4] = {};
    int step = threadIdx.x >> 5;
    short4 next = step_mv(f, step, m);
    for (; step < steps; step += kMatrixWarps) {
        const short4 mv = next;
        next = step_mv(f, step + kMatrixWarps, m);
        const uint32_t abits = __ballot_sync(kFullMask, (mv.x ^ mv.z) & 1);
        const uint32_t bbits = __ballot_sync(kFullMask, (mv.y ^ mv.w) & 1);
        const uint32_t a_lo = bit_bytes(abits, t4);
        const uint32_t a_hi = bit_bytes(abits, 16 + t4);
        const uint32_t b_lo = bit_bytes(bbits, t4);
        const uint32_t b_hi = bit_bytes(bbits, 16 + t4);
        for (int g = 0; g < tile_groups; ++g) {
#pragma unroll
            for (int j = 0; j < kMatrixAcc; ++j)
                mma_parity(acc[j], a_lo, a_hi, b_lo, b_hi);
        }
    }
    uint32_t total = 0;
#pragma unroll
    for (int j = 0; j < kMatrixAcc; ++j)
        total += static_cast<uint32_t>(acc[j][0]) +
                 static_cast<uint32_t>(acc[j][1]) +
                 static_cast<uint32_t>(acc[j][2]) +
                 static_cast<uint32_t>(acc[j][3]);
    total = mvt::block_sum(total, warp_sums);
    if (threadIdx.x == 0)
        sums[blockIdx.x] = static_cast<int32_t>(total);
}

}  // namespace

// Each entry point launches on `stream` of `device` (made current only where
// it is not) and returns the CUDA error (0 = launched), or
// cudaErrorInvalidValue for arguments its kernel does not take.

// C1 over rows uint8 [B, gh, pitch] -> sums int32 [B];
// ceil(gw / 8) <= pitch <= 4 * ceil(gw / 32), as for K1.
extern "C" int mvt_word_stream_control(const void* rows, int batch, int gh,
                                       int pitch, int gw, void* sums,
                                       int device, void* stream) {
    const int gww = (gw + 31) / 32;
    if (batch < 0 || gh < 0 || gw < 1 || pitch < (gw + 7) / 8 ||
        pitch > 4 * gww)
        return static_cast<int>(cudaErrorInvalidValue);
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    if (batch == 0 || gh == 0) return static_cast<int>(cudaGetLastError());
    int sms = 0, optin = 0;
    cudaError_t err = mvt::device_attribute<cudaDevAttrMultiProcessorCount>(
        device, &sms);
    if (err == cudaSuccess)
        err = mvt::device_attribute<cudaDevAttrMaxSharedMemoryPerBlockOptin>(
            device, &optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    const mvt::SpanLaunch span = mvt::span_launch(
        batch, sms, optin, static_cast<long long>(gh) * pitch);
    const uint8_t* r = static_cast<const uint8_t*>(rows);
    int32_t* out = static_cast<int32_t*>(sums);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool aligned =
        pitch % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 4 == 0;
    if (!span.shared)
        return launch_word<false, false>(r, batch, gh, pitch, gww, span,
                                         device, optin, out, s);
    return aligned ? launch_word<true, true>(r, batch, gh, pitch, gww, span,
                                             device, optin, out, s)
                   : launch_word<true, false>(r, batch, gh, pitch, gww, span,
                                              device, optin, out, s);
}

// C2 over luma uint8 [1 + B, H, W] -> grid int32 [B, gh, gw]; vec as for
// K6 (mvt_sad_block_grid).
extern "C" int mvt_sad_stream_control(const void* luma, int batch,
                                      int height, int width, int block,
                                      int gh, int gw, int vec, void* grid,
                                      int device, void* stream) {
    const int tpb = vec > 0 ? block / vec : 0;
    if ((vec != 1 && vec != 4 && vec != 16) || block % vec != 0 ||
        tpb < 1 || tpb > 32 || (tpb & (tpb - 1)) != 0 || width % vec != 0 ||
        gh > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    if (batch > 0 && gh > 0) {
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (vec == 16)
            launch_sad<16>(luma, batch, height, width, block, gh, gw, grid, s);
        else if (vec == 4)
            launch_sad<4>(luma, batch, height, width, block, gh, gw, grid, s);
        else
            launch_sad<1>(luma, batch, height, width, block, gh, gw, grid, s);
    }
    return static_cast<int>(cudaGetLastError());
}

// C3 over mvs int16 [B, M, 4] (8-byte aligned) + counts int32 [B] -> sums
// int32 [B].
extern "C" int mvt_mv_stream_control(const void* mvs, const void* mv_counts,
                                     int batch, int m, void* sums, int device,
                                     void* stream) {
    if (batch < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    if (batch == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return in_pairs(mvs, m)
               ? launch_stream<2>(mvs, mv_counts, batch, m, sums, device, s)
               : launch_stream<1>(mvs, mv_counts, batch, m, sums, device, s);
}

// The int32 cells of global scratch C9 needs, or -(CUDA error): 0 when a
// CTA's histogram of rows [max(y_min, 0), min(y_max, gh)), with the tile's
// scan, fits the shared memory one block of the current
// device may opt in to (227 KB on the H100); else one histogram a CTA for
// min(batch, 2 x SMs) CTAs.
extern "C" long long mvt_mv_votes_scratch(int batch, int gh, int gw,
                                          int y_min, int y_max) {
    int dev = 0, optin = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    const int stride = votes_stride(gh, gw, y_min, y_max);
    if (batch <= 0 || votes_smem(stride, true) <= static_cast<size_t>(optin))
        return 0;
    return static_cast<long long>(std::min(batch, 2 * sms)) * stride;
}

// C9 over mvs int16 [B, M, 4] (8-byte aligned) + counts int32 [B] -> sums
// int32 [B] = the kept MVs of frame b, by K4+K5's keep rule at the int64
// bound and shift; scratch == NULL keeps the histograms in shared memory,
// else scratch holds scratch_cells int32 (mvt_mv_votes_scratch).
extern "C" int mvt_mv_votes_control(const void* mvs, const void* mv_counts,
                                    int batch, int m, int gh, int gw,
                                    int y_min, int y_max, long long bound,
                                    int shift, void* scratch,
                                    long long scratch_cells, void* sums,
                                    int device, void* stream) {
    if (batch < 0 || m < 0 || gh < 0 || gw < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    if (batch == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return in_pairs(mvs, m)
               ? launch_votes_for<2>(mvs, mv_counts, batch, m, gh, gw, y_min,
                                     y_max, bound, shift, scratch,
                                     scratch_cells, sums, device, s)
               : launch_votes_for<1>(mvs, mv_counts, batch, m, gh, gw, y_min,
                                     y_max, bound, shift, scratch,
                                     scratch_cells, sums, device, s);
}

// C6 (mode 0), C7 (mode 1) and C8 (mode 2) over mvs int16 [B, M, 4]
// (8-byte aligned) + counts int32 [B] -> sums int32 [B]; sub int16 [B, M]
// for C7, ignored otherwise.
extern "C" int mvt_mv_capacity_control(const void* mvs, const void* mv_counts,
                                       const void* sub, int batch, int m,
                                       int mode, void* sums, int device,
                                       void* stream) {
    if (batch < 0 || m < 0 || mode < 0 || mode > 2 ||
        (mode == 1 && sub == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    if (batch > 0) {
        const short4* f = static_cast<const short4*>(mvs);
        const int32_t* c = static_cast<const int32_t*>(mv_counts);
        const int16_t* x = static_cast<const int16_t*>(sub);
        int32_t* out = static_cast<int32_t*>(sums);
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (mode == 0)
            mv_capacity_control_kernel<Capacity::kSum>
                <<<batch, kMvThreads, 0, s>>>(f, c, nullptr, m, out);
        else if (mode == 1)
            mv_capacity_control_kernel<Capacity::kSub>
                <<<batch, kMvThreads, 0, s>>>(f, c, x, m, out);
        else
            mv_capacity_control_kernel<Capacity::kLowBytes>
                <<<batch, kMvThreads, 0, s>>>(f, c, nullptr, m, out);
    }
    return static_cast<int>(cudaGetLastError());
}

// C10 over mvs int16 [B, M, 4] (8-byte aligned) -> sums int32 [B], at the
// padded grid gh_p (a multiple of 8) x gw_p (a multiple of 128).
extern "C" int mvt_mv_matrix_control(const void* mvs, int batch, int m,
                                     int gh_p, int gw_p, void* sums,
                                     int device, void* stream) {
    if (batch < 0 || m < 0 || gh_p < 0 || gw_p < 0 || gh_p % 8 != 0 ||
        gw_p % 128 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    // gw_p / 16 is a multiple of 8 = kMatrixAcc
    const int tile_groups = gw_p / 16 * (gh_p / 8) / kMatrixAcc;
    if (batch > 0)
        mv_matrix_control_kernel<<<batch, 32 * kMatrixWarps, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
            static_cast<const short4*>(mvs), m, tile_groups,
            static_cast<int32_t*>(sums));
    return static_cast<int>(cudaGetLastError());
}
