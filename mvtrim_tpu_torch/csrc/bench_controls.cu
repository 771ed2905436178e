// The bench's controls for Hopper (sm_90a).  C2 and C6-C8 keep a product
// kernel's launch (grid, CTA shape, frames a CTA, load width), read every
// byte the product kernel reads and do trivial, integer-exact arithmetic on
// it: their time is the practical memory ceiling of that launch on the card.
// C1, C3, C5 and C9 run on launches of their own, made for this card: what
// the card can stream of K1's rows (C1), stream and scatter of K4+K5's
// ragged payload (C3, C9), and decide of one held frame by K4+K5's whole
// rule (C5).  C10 runs the one-hot vote product's shapes on the tensor
// cores.  The bench (mvtrim_tpu_torch/bench/) holds the product kernels to
// them, beside the bound.  Nothing on the scan paths calls them.
//
// C1 mvt_word_stream_control replaces the TPU kernel bench.py:369
// build_control_sweep_T (benchmarks/word_bench.py's tctrl) over K1's rows
// uint8 [B, gh, pitch] (the bits at their own pitch, the words at 4 * gww):
//   sums[b] = sum over y < gh, c < ceil(gw / 32) of rows[b, y, 4c] & 1,
// bit 0 of each of K1's words.  What bounds it: the bytes, read once (2.09 MB
// at 1080p bits, B = 2048: 0.63 us at 3.35 TB/s); at that size the time is
// the card's fixed cost of a launch and one DRAM round trip.  Here a warp
// takes a frame, two frames a CTA, with no shared memory and no barrier:
// its 16-byte-aligned middle by 16-byte non-coherent loads, four a lane
// issued before any is used (a 1080p frame is two), its unaligned ends a
// byte a lane with them, so no byte past the frame is read; bit 0 of the
// bytes that start a word is picked out in registers by each byte's place
// in its row, whatever the pitch and the base; a shuffle sum and one store.
// Frames of any size stream the same way (8K at BLOCK_SHIFT 2: 259,200 B).
// On the H100 it runs as fast as K1's launch did (a TMA bulk copy of four
// frames a CTA, a barrier, a walk of shared memory) at the bits' 15-byte
// pitch, and faster on the words and at 4K (PERF.md): a one-wave kernel of
// a few MB sits near the card's floor for a launch in a CUDA graph.
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
// C5 mvt_mv_compute_control replaces mv_bench.py:469's measure of K4+K5's
// arithmetic ceiling: mv_cluster_op's decision, K4+K5's whole rule (the keep
// rule, the vote scatter, the bit the thr-th vote sets, the word rule, the
// reduction), with the frame index held at frame 0, so counts[b] and
// motion[b] are frame 0's decision for every b < B.  Every frame reads the
// held frame's count and rows afresh, as K4+K5 reads its own, so they come
// from the L2 and the time is the decision's.  What bounds it: the
// operations, about 12 an MV and 8 a centre cell a frame (1.86 us at 1080p,
// B = 2048, against the card's 67 T 32-bit operations/s).  On K4+K5's
// launch (one 512-thread CTA a frame, about five waves) it took 17% of
// that: each CTA zeroed the 7,440-cell histogram, passed four barriers and
// waited on two L2 round trips (the count, then the rows) in series.  Here
// it runs on C9's kind of launch: a frame to a 128-thread CTA (512 where
// the histogram passes 48 KB, a global scratch histogram a CTA past a
// block's shared memory), a persistent grid taking the frames in turn; the
// histogram zeroed once a launch and, after each frame, cleared by the
// cells the threads hit (all of them after a frame of several passes), the
// words reset; three barriers a frame; the next frame's count read a frame
// ahead and its first pass of units loaded into registers while this
// frame's rule runs, so a frame's L2 round trips overlap the last one's
// rule.  The counters stay 32 bits, so votes never wrap.  At full 1080p
// lists (8,192 shared atomics a frame) it is slower than K4+K5's launch
// was; no CTA shape tried recovered that (PERF.md).
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
// What bounds the rest: C2, C3 and C6-C9 bytes, as their product kernels
// at those launches (the arithmetic is a mask, an add or a popcount a load;
// C9's keep rule and atomic about 12 integer operations an MV); C10 the
// tensor cores' int8 rate (2 gh_p gw_p M B operations against 8 M B bytes).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "cluster_words.cuh"
#include "launch.cuh"
#include "mv_keep.cuh"

namespace {

using mvt::kFullMask;

constexpr uint32_t kBit0 = 0x01010101u;  // bit 0 of each byte of a word

// Four bits -> four bytes of 0 or 1, bit i in byte i (C1's byte masks; in
// C10, element i of an s8 fragment register is its byte i).
__device__ __forceinline__ uint32_t bit_bytes(uint32_t bits, int shift) {
    return (((bits >> shift) & 15u) * 0x00204081u) & 0x01010101u;
}

// --- C1: K1's rows, a warp a frame, every load in flight at once ---

constexpr int kBitWarps = 2;   // frames (warps) a CTA
constexpr int kBitUnroll = 4;  // 16-byte loads a lane issues before any use

// Bit i set where byte i of a 16-byte chunk whose first byte is byte p of a
// row of `pitch` bytes (rows back to back) is a word's first byte: ((p + i)
// mod pitch) mod 4 == 0.
__device__ __forceinline__ uint32_t word_starts(int p, int pitch) {
    if (pitch >= 16) {  // at most one row boundary in the chunk
        const uint32_t own = 0x1111u << ((4 - (p & 3)) & 3);
        const int next = pitch - p;  // the next row's first byte, >= 1
        if (next >= 16) return own;
        const uint32_t before = (1u << next) - 1u;
        return (own & before) | ((0x1111u << (next & 3)) & ~before & 0xffffu);
    }
    // a row's word starts, shifted to each row that begins in the chunk
    const uint32_t row = 0x1111u & ((1u << pitch) - 1u);
    uint32_t starts = row >> p;
    for (int s = pitch - p; s < 16; s += pitch) starts |= row << s;
    return starts & 0xffffu;
}

// The chunk's count of set bit 0 among its bytes that start a word.
__device__ __forceinline__ uint32_t chunk_bits(uint4 d, uint32_t starts) {
    return __popc(d.x & bit_bytes(starts, 0)) +
           __popc(d.y & bit_bytes(starts, 4)) +
           __popc(d.z & bit_bytes(starts, 8)) +
           __popc(d.w & bit_bytes(starts, 12));
}

// Warp w of CTA c takes frame c * kBitWarps + w: its 16-byte-aligned middle
// by 16-byte non-coherent loads, kBitUnroll a lane issued before any is
// used, and its unaligned ends (up to 15 bytes each) a byte a lane, issued
// with the first loads; a shuffle sum and one store.
__global__ void __launch_bounds__(32 * kBitWarps)
word_bit0_control_kernel(const uint8_t* __restrict__ rows, int batch,
                         int frame_bytes, int pitch,
                         int32_t* __restrict__ sums) {
    const int f = blockIdx.x * kBitWarps + (threadIdx.x >> 5);
    if (f >= batch) return;
    const int lane = threadIdx.x & 31;
    const uint8_t* frame = rows + static_cast<size_t>(f) * frame_bytes;
    const int head = min(
        static_cast<int>((16 - (reinterpret_cast<uintptr_t>(frame) & 15)) &
                         15),
        frame_bytes);
    const int chunks = (frame_bytes - head) >> 4;
    const int tail = head + 16 * chunks;  // the end bytes from here
    // lanes 0-15 the head's bytes, 16-31 the tail's
    const int o = lane < 16 ? lane : tail + lane - 16;
    const bool end_byte = lane < 16 ? lane < head : o < frame_bytes;
    const uint4* mid = reinterpret_cast<const uint4*>(frame + head);
    uint32_t total = 0, byte = 0;
    for (int c0 = lane;; c0 += 32 * kBitUnroll) {
        uint4 d[kBitUnroll];
#pragma unroll
        for (int j = 0; j < kBitUnroll; ++j) {
            const int c = c0 + 32 * j;
            if (c < chunks) d[j] = __ldg(mid + c);
        }
        // the end byte after the first pass's loads, not before them: a
        // use of it placed ahead of those loads would wait out its round
        // trip before they issue
        if (c0 == lane && end_byte) byte = __ldg(frame + o);
#pragma unroll
        for (int j = 0; j < kBitUnroll; ++j) {
            const int c = c0 + 32 * j;
            if (c < chunks)
                total += chunk_bits(d[j],
                                    word_starts((head + 16 * c) % pitch, pitch));
        }
        if (c0 + 32 * kBitUnroll >= chunks) break;
    }
    if (end_byte && ((o % pitch) & 3) == 0) total += byte & 1u;
    for (int off = 16; off > 0; off >>= 1)
        total += __shfl_down_sync(kFullMask, total, off);
    if (lane == 0) sums[f] = static_cast<int32_t>(total);
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

// --- C5: K4+K5's decision over one held frame, a frame to a small CTA ---

constexpr int kComputeThreads = 128;
constexpr int kComputeUnroll = 4;

// The first pass's units of a frame, k = k0, k0 + kThreads, ... below
// `units`, into registers.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_pass(Unit<kRows> (&u)[kComputeUnroll],
                                          const Unit<kRows>* src, int units,
                                          int k0) {
#pragma unroll
    for (int j = 0; j < kComputeUnroll; ++j) {
        const int k = k0 + j * kThreads;
        if (k < units) u[j] = __ldg(src + k);
    }
}

// One MV's vote, K4+K5's: a kept MV adds one to its cell, and the vote that
// lifts a cell to thr sets its word bit (a count passes each value below
// its total once, so the bit ends set exactly when the cell's votes reach
// thr >= 1).  Returns the cell, or -1 for an MV the rule drops.
__device__ __forceinline__ int vote(short4 mv, long long bound, int shift,
                                    int gw, int gww, int y_lo, int y_hi,
                                    int thr, int32_t* hist, uint32_t* words) {
    int r, gx;
    if (!mvt::kept_cell(mv, bound, shift, gw, y_lo, y_hi, r, gx)) return -1;
    const int c = r * gw + gx;
    if (atomicAdd(hist + c, 1) + 1 == thr)
        atomicOr(words + r * gww + (gx >> 5), 1u << (gx & 31));
    return c;
}

// C5.  The CTAs take the frames in turn; frame f reads the count and rows
// of frame f * held (held = 0 from the entry: a runtime 0, so the loads
// stay inside the frame loop and every frame reads the held frame afresh).
// The histogram (shared memory, or `cells` of global scratch a CTA) is
// zeroed once a launch; each frame: its kept MVs vote (the first pass from
// registers loaded while the last frame's rule ran), a barrier, the word
// rule (count_rows) and the block sum, counts[f] and motion[f] stored once;
// then the cells the threads hit are cleared from the indices they still
// hold (all cells where the frame took more than one pass) and the words
// reset.  The next frame's count is loaded a frame ahead of its units.
template <int kRows, bool kShared, int kThreads>
__global__ void __launch_bounds__(kThreads)
mv_compute_control_kernel(const short4* __restrict__ mvs,
                          const int32_t* __restrict__ mv_counts, int batch,
                          int m, int held, int gh, int gw, int y_min,
                          int y_max, long long bound, int thr, int need,
                          int shift, int32_t* __restrict__ scratch,
                          int32_t* __restrict__ counts,
                          uint8_t* __restrict__ motion) {
    // (uint8_t, as the other kernels of this file declare it)
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t* warp_sums = reinterpret_cast<uint32_t*>(smem);
    uint32_t* words = warp_sums + 32;
    const int y_lo = mvt::window_lo(y_min);
    const int rows = mvt::window_rows(gh, y_min, y_max);
    const int y_hi = y_lo + rows;
    const int gww = (gw + 31) >> 5;
    const int cells = rows * gw;
    const int n_words = rows * gww;
    int32_t* hist =
        kShared ? reinterpret_cast<int32_t*>(
                      warp_sums + mvt::words_before_hist(rows, gw))
                : scratch + static_cast<size_t>(blockIdx.x) * cells;
    const int tid = threadIdx.x;
    const int grid = gridDim.x;
    const uint32_t fill = mvt::fill_word(thr);
    constexpr int kPass = kThreads * kComputeUnroll;  // units a pass
    auto count_of = [&](int f) {
        return f < batch ? __ldg(mv_counts + static_cast<size_t>(f) * held)
                         : 0;
    };
    auto units_of = [&](int count) {
        return (min(max(count, 0), m) + kRows - 1) / kRows;
    };
    auto frame = [&](int f) {
        return reinterpret_cast<const Unit<kRows>*>(
            mvs + static_cast<size_t>(f) * held * m);
    };
    auto zero_hist = [&]() {
        if constexpr (kShared) {  // 16-byte aligned
            int4* quads = reinterpret_cast<int4*>(hist);
            for (int i = tid; i < cells >> 2; i += kThreads)
                quads[i] = make_int4(0, 0, 0, 0);
            for (int i = (cells & ~3) + tid; i < cells; i += kThreads)
                hist[i] = 0;
        } else {
            for (int i = tid; i < cells; i += kThreads) hist[i] = 0;
        }
    };

    int f = blockIdx.x;
    int count = count_of(f);
    int next = count_of(f + grid);
    zero_hist();
    for (int i = tid; i < n_words; i += kThreads) words[i] = fill;
    Unit<kRows> u[kComputeUnroll];
    load_pass<kRows, kThreads>(u, frame(f), units_of(count), tid);
    __syncthreads();
    for (; f < batch; f += grid) {
        const int after = count_of(f + 2 * grid);
        const int n = min(max(count, 0), m);
        const int units = (n + kRows - 1) / kRows;
        const Unit<kRows>* src = frame(f);
        int cell[kComputeUnroll][2];
        for (int k0 = tid;;) {
#pragma unroll
            for (int j = 0; j < kComputeUnroll; ++j) {
                const int k = k0 + j * kThreads;
                cell[j][0] = cell[j][1] = -1;
                if (k < units)
                    cell[j][0] = vote(first_mv<kRows>(u[j]), bound, shift, gw,
                                      gww, y_lo, y_hi, thr, hist, words);
                if constexpr (kRows == 2)
                    if (k < units && 2 * k + 1 < n)
                        cell[j][1] = vote(second_mv(u[j]), bound, shift, gw,
                                          gww, y_lo, y_hi, thr, hist, words);
            }
            k0 += kPass;
            if (k0 >= units) break;
            load_pass<kRows, kThreads>(u, src, units, k0);
        }
        __syncthreads();  // the frame's votes are whole
        // the next frame's first pass is in flight through the rule
        load_pass<kRows, kThreads>(u, frame(f + grid), units_of(next), tid);
        uint32_t total = mvt::count_rows(words, y_lo, y_hi, gww, gw, y_lo,
                                         y_hi, fill, tid, kThreads);
        // block_sum's barrier follows every thread's reads of the words
        total = mvt::block_sum(total, warp_sums);
        if (tid == 0) {
            counts[f] = static_cast<int32_t>(total);
            motion[f] = static_cast<int>(total) >= need && count > 0 ? 1 : 0;
        }
        if (units <= kPass) {
#pragma unroll
            for (int j = 0; j < kComputeUnroll; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    if (cell[j][h] >= 0) hist[cell[j][h]] = 0;
        } else {
            zero_hist();
        }
        for (int i = tid; i < n_words; i += kThreads) words[i] = fill;
        __syncthreads();  // cleared before the next frame's votes
        count = next;
        next = after;
    }
}

template <int kRows, bool kShared, int kThreads>
int launch_compute(const void* mvs, const void* mv_counts, int batch, int m,
                   int gh, int gw, int y_min, int y_max, long long bound,
                   int thr, int need, int shift, void* scratch,
                   long long scratch_cells, void* counts, void* motion,
                   int device, cudaStream_t s) {
    const int rows = mvt::window_rows(gh, y_min, y_max);
    const size_t smem = mvt::hist_shared_bytes(rows, gw, kShared);
    int blocks = 0;
    const cudaError_t err = persistent_grid<10 + (kRows - 1) + 2 * kShared +
                                            4 * (kThreads != 512)>(
        reinterpret_cast<const void*>(
            &mv_compute_control_kernel<kRows, kShared, kThreads>),
        kThreads, device, smem, batch, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!kShared) {
        // one histogram of scratch a CTA
        const long long fit = scratch_cells / (1LL * rows * gw);
        if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
        blocks = static_cast<int>(std::min<long long>(fit, blocks));
    }
    mv_compute_control_kernel<kRows, kShared, kThreads>
        <<<blocks, kThreads, smem, s>>>(
            static_cast<const short4*>(mvs),
            static_cast<const int32_t*>(mv_counts), batch, m, 0, gh, gw,
            y_min, y_max, bound, thr, need, shift,
            static_cast<int32_t*>(scratch), static_cast<int32_t*>(counts),
            static_cast<uint8_t*>(motion));
    return static_cast<int>(cudaGetLastError());
}

// C5's launch for the histogram's place and size.  Its shared memory is
// K4+K5's layout (mv_keep.cuh), so mvt_mv_cluster_scratch's answer of
// where the histogram goes holds for C5.
template <int kRows>
int launch_compute_for(const void* mvs, const void* mv_counts, int batch,
                       int m, int gh, int gw, int y_min, int y_max,
                       long long bound, int thr, int need, int shift,
                       void* scratch, long long scratch_cells, void* counts,
                       void* motion, int device, cudaStream_t s) {
    const int rows = mvt::window_rows(gh, y_min, y_max);
    if (scratch != nullptr && rows > 0 && gw > 0)
        return launch_compute<kRows, false, kWideThreads>(
            mvs, mv_counts, batch, m, gh, gw, y_min, y_max, bound, thr, need,
            shift, scratch, scratch_cells, counts, motion, device, s);
    if (mvt::hist_shared_bytes(rows, gw, true) <= kNarrowHistBytes)
        return launch_compute<kRows, true, kComputeThreads>(
            mvs, mv_counts, batch, m, gh, gw, y_min, y_max, bound, thr, need,
            shift, nullptr, 0, counts, motion, device, s);
    return launch_compute<kRows, true, kWideThreads>(
        mvs, mv_counts, batch, m, gh, gw, y_min, y_max, bound, thr, need,
        shift, nullptr, 0, counts, motion, device, s);
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
    const long long frame_bytes = static_cast<long long>(gh) * pitch;
    if (frame_bytes > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    word_bit0_control_kernel<<<(batch + kBitWarps - 1) / kBitWarps,
                               32 * kBitWarps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), batch,
        static_cast<int>(frame_bytes), pitch, static_cast<int32_t*>(sums));
    return static_cast<int>(cudaGetLastError());
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

// C5 over mv_cluster_op's arguments (mvt_mv_cluster_counts'), the frame
// index held at frame 0: counts[b] and motion[b] are frame 0's decision for
// every b < batch.  scratch == NULL keeps the histograms in shared memory,
// else scratch holds scratch_cells int32 (mvt_mv_cluster_scratch), one
// histogram a CTA.
extern "C" int mvt_mv_compute_control(const void* mvs, const void* mv_counts,
                                      int batch, int m, int gh, int gw,
                                      int y_min, int y_max, long long bound,
                                      int thr, int need, int shift,
                                      void* scratch, long long scratch_cells,
                                      void* counts, void* motion, int device,
                                      void* stream) {
    if (batch < 0 || m < 0 || gh < 0 || gw < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const mvt::DeviceGuard guard(device);
    if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
    if (batch == 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return in_pairs(mvs, m)
               ? launch_compute_for<2>(mvs, mv_counts, batch, m, gh, gw,
                                       y_min, y_max, bound, thr, need, shift,
                                       scratch, scratch_cells, counts, motion,
                                       device, s)
               : launch_compute_for<1>(mvs, mv_counts, batch, m, gh, gw,
                                       y_min, y_max, bound, thr, need, shift,
                                       scratch, scratch_cells, counts, motion,
                                       device, s);
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
