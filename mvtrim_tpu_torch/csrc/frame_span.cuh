// A CTA's span of consecutive frames, brought into shared memory with one
// TMA 1-D bulk copy: the loader of the word-domain cluster kernel
// (word_cluster.cu).
//
// The frames are rows of bytes [B, gh, pitch]; a CTA takes F consecutive
// frames, one warp a frame.  One thread issues a bulk copy
// (cp.async.bulk, completing on an mbarrier) of the span's 16-byte-aligned
// middle; plain loads take the unaligned head and tail, and no byte past
// the span is read.  A frame larger than one block's shared memory is read
// from device memory a byte at a time instead (GlobalFrame).

#pragma once

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace mvt {

constexpr int kMaxFrames = 32;     // frames (warps) a CTA
constexpr int kBarrierBytes = 16;  // the mbarrier, padded to 16 bytes

// Shared-memory bytes for F frames of frame_bytes: the barrier, up to 15
// bytes before the span's first byte (it keeps its address mod 16), the span
// and one word that the last unaligned read may touch past it.
inline long long shared_bytes(int frames, long long frame_bytes) {
    return kBarrierBytes + 16 + frames * frame_bytes + 16;
}

// A launch over the span: F frames a CTA (one wave of about four CTAs an
// SM, at most kMaxFrames), whether F frames fit in one block's shared
// memory, and the dynamic shared memory a CTA takes (0 without it).
struct SpanLaunch {
    int frames;
    bool shared;
    long long smem;
};

inline SpanLaunch span_launch(int batch, int sms, int optin,
                              long long frame_bytes) {
    SpanLaunch s;
    s.frames = std::min(kMaxFrames, (batch + 4 * sms - 1) / (4 * sms));
    const long long fit =
        (optin - shared_bytes(0, frame_bytes)) / frame_bytes;
    s.shared = fit >= 1;
    if (s.shared)
        s.frames = static_cast<int>(std::min<long long>(s.frames, fit));
    s.smem = s.shared ? shared_bytes(s.frames, frame_bytes) : 0;
    return s;
}

// A CTA's span in shared memory: byte o of the span lies at bytes[head + o],
// bytes 16-byte aligned.
template <bool kAligned>
struct SharedSpan {
    const uint32_t* words;  // bytes, as 32-bit words
    const uint8_t* bytes;
    int head;

    // bytes o..o+3 of the span, little-endian
    __device__ __forceinline__ uint32_t word(int o, int) const {
        o += head;
        if (kAligned) return words[o >> 2];
        return __funnelshift_r(words[o >> 2], words[(o >> 2) + 1],
                               8 * (o & 3));
    }
    __device__ __forceinline__ uint32_t byte(int o) const {
        return bytes[head + o];
    }
};

// One frame in device memory, read a byte at a time; `avail` bytes of the
// row are left from o, so nothing past the row is read.
struct GlobalFrame {
    const uint8_t* bytes;

    __device__ __forceinline__ uint32_t word(int o, int avail) const {
        uint32_t w = 0;
        for (int i = 0; i < 4 && i < avail; ++i)
            w |= static_cast<uint32_t>(__ldg(bytes + o + i)) << (8 * i);
        return w;
    }
    __device__ __forceinline__ uint32_t byte(int o) const {
        return __ldg(bytes + o);
    }
};

__device__ __forceinline__ uint32_t shared_address(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (a multiple of 16, 16-byte-aligned ends) with one bulk
// copy completing on `barrier`, which it initialises; 0 bytes completes the
// barrier's phase at once.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* barrier) {
    const uint32_t bar = shared_address(barrier);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
    if (bytes > 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n" ::"r"(shared_address(dst)),
            "l"(src), "r"(bytes), "r"(bar)
            : "memory");
}

__device__ __forceinline__ void wait_phase0(uint64_t* barrier) {
    const uint32_t bar = shared_address(barrier);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n"
            " .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            " selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar)
            : "memory");
    } while (!done);
}

// Starts bringing the span's len bytes into shared memory at data + head,
// head = the span's address mod 16, and returns head: thread 0 issues the
// bulk copy of the aligned middle on `barrier`, the threads copy the head
// and tail.  The caller then passes a __syncthreads() and waits on the
// barrier (wait_phase0) before it reads.
__device__ __forceinline__ int load_span(const uint8_t* span, int len,
                                         uint8_t* data, uint64_t* barrier) {
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(span) & 15);
    // [a, d): the span's 16-byte-aligned middle, as offsets into it
    const int a = min((16 - head) & 15, len);
    const int d = max(a, ((head + len) & ~15) - head);
    if (threadIdx.x == 0)
        bulk_copy(data + head + a, span + a, d - a, barrier);
    for (int i = threadIdx.x; i < a; i += blockDim.x)
        data[head + i] = span[i];
    for (int i = d + threadIdx.x; i < len; i += blockDim.x)
        data[head + i] = span[i];
    return head;
}

}  // namespace mvt
