// Stream controls for Hopper (sm_90a): for three of the port's kernels, a
// kernel with the same launch (grid, CTA shape, frames a CTA, load width)
// that reads every byte the product kernel reads and does trivial,
// integer-exact arithmetic on it.  Its time is the practical memory ceiling
// of that launch on the card, the yardstick the bench
// (mvtrim_tpu_torch/bench/) holds each product kernel to, beside the bound.
// Nothing on the scan paths calls them.
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
// C3 mvt_mv_stream_control replaces mv_bench.py's ctrl and follows K4+K5
// (mv_cluster.cu): one 512-thread CTA a frame, one 8-byte short4 load an
// MV, eight in flight a thread, and a loop bound equal to the count:
//   sums[b] = count[b] + sum over k < min(count[b], M) of
//             dst_x + dst_y + src_x + src_y,
// widened to 32 bits and wrapped mod 2^32.  At full counts that is the TPU
// control's per-frame sum (which reads all M slots); at sparse counts the
// TPU control still reads every slot while this launch, like K4+K5, reads
// only the rows below the count.
//
// What bounds them: bytes, as their product kernels at those launches; the
// arithmetic is a mask, an add or a popcount a load.

#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "cluster_words.cuh"
#include "frame_span.cuh"
#include "launch.cuh"

namespace {

using mvt::kFullMask;
using mvt::kMaxFrames;

constexpr uint32_t kBit0 = 0x01010101u;  // bit 0 of each byte of a word
constexpr int kMvThreads = 512;

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

// --- C3: K4+K5's launch ---

__global__ void __launch_bounds__(kMvThreads)
mv_stream_control_kernel(const short4* __restrict__ mvs,
                         const int32_t* __restrict__ mv_counts, int m,
                         int32_t* __restrict__ sums) {
    __shared__ uint32_t warp_sums[32];
    const int b = blockIdx.x;
    const int count = mv_counts[b];
    const int n = min(max(count, 0), m);
    const short4* f = mvs + static_cast<size_t>(b) * m;
    uint32_t total = 0;
#pragma unroll 8
    for (int k = threadIdx.x; k < n; k += kMvThreads) {
        const short4 mv = __ldg(f + k);
        total += static_cast<uint32_t>(static_cast<int>(mv.x) + mv.y + mv.z +
                                       mv.w);
    }
    total = mvt::block_sum(total, warp_sums);
    if (threadIdx.x == 0)
        sums[b] = static_cast<int32_t>(total + static_cast<uint32_t>(count));
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
    if (batch > 0)
        mv_stream_control_kernel<<<batch, kMvThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
            static_cast<const short4*>(mvs),
            static_cast<const int32_t*>(mv_counts), m,
            static_cast<int32_t*>(sums));
    return static_cast<int>(cudaGetLastError());
}
