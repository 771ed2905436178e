// Word-domain cluster count for Hopper (sm_90a): the kernel of the bits and
// words payloads, the default scan path.
//
// Replaces the TPU kernel mvtrim_tpu/ops/cluster.py:word_cluster_counts_T
// (make_cluster_words_op_pallas_T, K1), and with it the lane-major
// word_cluster_counts (make_cluster_words_op_pallas, K2): the same math on
// another layout.
//
// Input: uint8 rows [B, gh, pitch], contiguous.  pitch = ceil(gw / 8) for the
// bits payload (native mvt_scan_bits), 4 * gww for the words payload (native
// mvt_scan_words, int32 [B, gh * gww] read as bytes), gww = ceil(gw / 32).
// Word c of row y is bytes 4c..4c+3 of the row, little-endian, a byte at or
// past the pitch reading 0: bit k of word c is cell x = 32c + k, which is
// what the TPU kernel computes on repack_bits_words(bits).  The rule and the
// centre bits are cluster_words.cuh's (cluster_bits, center_bits); counts[b]
// is the popcount sum over the centre rows [y_min, y_max), motion[b] =
// counts[b] >= need.  Bits past gw in a row's last byte never reach a centre
// cell: a centre cell's 4-neighbours lie at x <= gw - 1.
//
// What bounds it on the H100: the bytes, and at the pipeline's batches the
// fixed cost of a launch.  A frame moves the rows its counts depend on (the
// centre rows and one more on each side, inside the grid) and writes 5
// bytes: 965 B at 1080p in bits, 0.59 us for B = 2048 at 3.35 TB/s, against
// ~25 integer operations a word of 32 cells.  The first design (one warp a
// frame, each lane loading a word and its four neighbours from device
// memory in a loop, with a division a word) kept about 260 KB in flight
// across the card, where HBM's latency needs about 2 MB: 5.8-6.1 us.
//
// Design: a CTA takes F consecutive frames, one warp a frame, F picked by the
// C entry point from B and the SM count so that the batch runs in one wave of
// about four CTAs an SM (F = 4 at B = 2048, 2 at B = 750 on 132 SMs).  The F
// frames are one contiguous span, and one thread brings it into shared
// memory with TMA's 1-D bulk copy (cp.async.bulk, completing on an
// mbarrier), so all of the CTA's bytes are in flight at once and the copy
// costs no registers.  The copy takes the span's 16-byte-aligned middle;
// plain loads take the unaligned head and tail, and no byte past the span is
// read (a bits frame is 1,020 B at 1080p, and the base may sit anywhere);
// frame_span.cuh holds that loader and the choice of F, which the stream
// control of this launch (bench_controls.cu) shares.  The rule then runs from shared memory: lane l takes word column c = l %
// gww of a band of rows, walking down it with the rows above and below in
// registers, so each row costs one word read (two aligned 32-bit reads and a
// __funnelshift_r at an unaligned pitch, one where pitch and base are 4-byte
// aligned) and two byte reads for the neighbouring words' edge bits; only
// rows [y_min, y_max) are walked, no division a word, and a warp-shuffle sum
// gives the frame's count.  Measured on the H100 (PERF.md): 3.2 us at
// 1080p B = 750, 4.1 us at B = 2048 and 7.5 us at 4K in bits, 1.3-1.9
// times a PyTorch copy of the same bytes; cutting the copy into a piece a
// frame with a barrier each, one CTA an SM, and two to eight warps a frame
// were each slower.
//
// For a frame larger than one block's shared memory (8K at BLOCK_SHIFT 2:
// 259,200 B), the C entry point picks a variant in which each warp reads
// its frame from device memory a byte at a time.

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

// The warp's count of cluster cells over rows [y_lo, y_hi) of the frame whose
// row y starts at byte base + y * pitch of src (summed in lane 0).  Lane l
// walks word column l % gww down band l / gww of the rows, 32 / gww bands a
// warp; rows of more than 32 words take columns l, l + 32, ... and one band.
template <class Src>
__device__ __forceinline__ uint32_t count_frame(const Src& src, int base,
                                                int gh, int pitch, int gw,
                                                int gww, int y_lo, int y_hi) {
    const int lane = threadIdx.x & 31;
    const int bands = gww <= 32 ? 32 / gww : 1;
    const int band = gww <= 32 ? lane / gww : 0;
    const int len = (y_hi - y_lo + bands - 1) / bands;
    const int y0 = y_lo + band * len;
    const int y1 = min(y0 + len, y_hi);
    uint32_t total = 0;
    if (band < bands && y0 < y1) {
        for (int c = gww <= 32 ? lane % gww : lane; c < gww; c += 32) {
            const int avail = pitch - 4 * c;  // >= 1: 4 (gww - 1) < pitch
            const uint32_t keep =
                avail >= 4 ? kFullMask : (1u << (8 * avail)) - 1u;
            const uint32_t center = mvt::center_bits(c, gw);
            int o = base + y0 * pitch + 4 * c;
            uint32_t up = y0 > 0 ? src.word(o - pitch, avail) : 0u;
            uint32_t w = src.word(o, avail) & keep;
            for (int y = y0; y < y1; ++y, o += pitch) {
                const uint32_t down =
                    y + 1 < gh ? src.word(o + pitch, avail) : 0u;
                // only bit 7 of the byte before and bit 0 of the byte after
                // reach the word (cluster_bits reads prev >> 31, next << 31)
                const uint32_t prev = c > 0 ? src.byte(o - 1) << 24 : 0u;
                const uint32_t next = avail > 4 ? src.byte(o + 4) : 0u;
                total += __popc(mvt::cluster_bits(w, prev, next, up, down) &
                                center);
                up = w;
                w = down & keep;
            }
        }
    }
    for (int off = 16; off > 0; off >>= 1)
        total += __shfl_down_sync(kFullMask, total, off);
    return total;
}

// kShared: the CTA's span bulk-copied to shared memory; else each warp reads
// its frame from device memory.
template <bool kShared, bool kAligned>
__global__ void __launch_bounds__(32 * kMaxFrames)
word_cluster_kernel(const uint8_t* __restrict__ rows, int batch, int gh,
                    int pitch, int gw, int y_lo, int y_hi, int need,
                    int32_t* __restrict__ counts,
                    uint8_t* __restrict__ motion) {
    const int frames = blockDim.x >> 5;
    const int f0 = blockIdx.x * frames;
    const int nf = min(frames, batch - f0);
    const int k = threadIdx.x >> 5;
    const int gww = (gw + 31) >> 5;
    const long long frame_bytes = static_cast<long long>(gh) * pitch;
    uint32_t total;
    if constexpr (!kShared) {
        if (k >= nf) return;
        const mvt::GlobalFrame src{rows + (f0 + k) * frame_bytes};
        total = count_frame(src, 0, gh, pitch, gw, gww, y_lo, y_hi);
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
        total = count_frame(src, static_cast<int>(k * frame_bytes), gh, pitch,
                            gw, gww, y_lo, y_hi);
    }
    if ((threadIdx.x & 31) == 0) {
        counts[f0 + k] = static_cast<int32_t>(total);
        motion[f0 + k] = static_cast<int>(total) >= need ? 1 : 0;
    }
}

// Lets the kernel take up to `optin` bytes of dynamic shared memory on
// `device`, asked of the CUDA runtime once a device.
template <bool kAligned>
cudaError_t allow_shared(int device, int optin) {
    static std::atomic<bool> done[mvt::kMaxDevices];
    const bool cached = device >= 0 && device < mvt::kMaxDevices;
    if (cached && done[device].load(std::memory_order_relaxed))
        return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        word_cluster_kernel<true, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess && cached)
        done[device].store(true, std::memory_order_relaxed);
    return err;
}

template <bool kShared, bool kAligned>
int launch(const uint8_t* rows, int batch, int gh, int pitch, int gw,
           int y_lo, int y_hi, int need, int frames, long long smem,
           int device, int optin, int32_t* counts, uint8_t* motion,
           cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t err = allow_shared<kAligned>(device, optin);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    word_cluster_kernel<kShared, kAligned>
        <<<(batch + frames - 1) / frames, 32 * frames,
           static_cast<size_t>(smem), stream>>>(rows, batch, gh, pitch, gw,
                                                y_lo, y_hi, need, counts,
                                                motion);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` of `device` (made current only where it is not) and
// returns the CUDA error (0 = launched): the bulk copy to shared memory
// where a frame fits in one block's, else device-memory reads.  need =
// max(1, clusters_needed), applied by the caller.  ceil(gw / 8) <= pitch <=
// 4 * ceil(gw / 32).
extern "C" int mvt_word_cluster_counts(const void* rows, int batch, int gh,
                                       int pitch, int gw, int y_min,
                                       int y_max, int need, void* counts,
                                       void* motion, int device,
                                       void* stream) {
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
    const int y_lo = std::max(y_min, 0);
    const int y_hi = std::max(y_lo, std::min(y_max, gh));
    const uint8_t* r = static_cast<const uint8_t*>(rows);
    int32_t* c = static_cast<int32_t*>(counts);
    uint8_t* m = static_cast<uint8_t*>(motion);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool aligned =
        pitch % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 4 == 0;
#define MVT_LAUNCH(S, A)                                                 \
    launch<S, A>(r, batch, gh, pitch, gw, y_lo, y_hi, need, span.frames, \
                 span.smem, device, optin, c, m, s)
    if (!span.shared) return MVT_LAUNCH(false, false);
    return aligned ? MVT_LAUNCH(true, true) : MVT_LAUNCH(true, false);
#undef MVT_LAUNCH
}
