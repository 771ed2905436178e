// Block sum of absolute differences for Hopper (sm_90a).
//
// Replaces the TPU kernel mvtrim_tpu/ops/sad.py:make_sad_kernel (via
// make_sad_op_pallas; its per-frame math is sad_step_counts/_sad_grid), and
// with it make_sad_kernel_sliced, which is the same function cut into lane
// halves to fit the TPU's VMEM at 4K.  The cluster rule that ends the TPU
// kernel runs after this one, as cluster_map.cu over the int32 grid.
//
// Input: luma uint8 [1 + B, H, W], contiguous and unpadded; frame 0 is the
// carry and is only ever a `prev`.  Output: grid int32 [B, gh, gw] with
//
//   grid[b, by, bx] = sum over the pixels of block (by, bx) that lie in the
//                     frame of |luma[b + 1] - luma[b]|
//
// Pixels of a partial edge block past row H or column W are never read: they
// count as zero difference, which is what the TPU path's zero padding gives.
// Every sum is exact uint32 arithmetic (a 16x16 block reaches 65,280); no
// float, no tensor core, so nothing rounds (the TPU kernel needed a bf16
// hi/lo split for this).
//
// What bounds it: bytes.  A window of B frames at 1080p reads 1 + B planes of
// 2,073,600 B and writes 4 * gh * gw B per frame; the arithmetic is one
// __vabsdiffu4 and one __dp4a per 4 pixels.  Design: one CTA per (frame,
// block row), frames on grid x so that the CTAs for frames b and b + 1 at
// one block row run together and the plane they share is read from HBM once
// and from L2 the second time.  Threads stride over units of VEC consecutive
// columns (16, 4 or 1 bytes: the widest load that the row pitch and the
// base address keep aligned, so a pitch such as W = 1000 takes 4-byte loads
// and never a misaligned 16-byte one); each thread sums its unit over the
// block's rows, and the block/VEC threads of one block column reduce with
// __shfl_down_sync.  No shared memory, no allocation.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kOnes = 0x01010101u;

__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
    return __dp4a(__vabsdiffu4(a, b), kOnes, acc);
}

// Sum of |cur - prev| over VEC bytes at cur/prev (aligned to VEC).
template <int VEC>
__device__ __forceinline__ uint32_t unit_sad(const uint8_t* cur,
                                             const uint8_t* prev,
                                             uint32_t acc);

template <>
__device__ __forceinline__ uint32_t unit_sad<16>(const uint8_t* cur,
                                                 const uint8_t* prev,
                                                 uint32_t acc) {
    const uint4 c = __ldg(reinterpret_cast<const uint4*>(cur));
    const uint4 p = __ldg(reinterpret_cast<const uint4*>(prev));
    acc = sad4(c.x, p.x, acc);
    acc = sad4(c.y, p.y, acc);
    acc = sad4(c.z, p.z, acc);
    return sad4(c.w, p.w, acc);
}

template <>
__device__ __forceinline__ uint32_t unit_sad<4>(const uint8_t* cur,
                                                const uint8_t* prev,
                                                uint32_t acc) {
    return sad4(__ldg(reinterpret_cast<const uint32_t*>(cur)),
                __ldg(reinterpret_cast<const uint32_t*>(prev)), acc);
}

template <>
__device__ __forceinline__ uint32_t unit_sad<1>(const uint8_t* cur,
                                                const uint8_t* prev,
                                                uint32_t acc) {
    const int d = static_cast<int>(__ldg(cur)) - static_cast<int>(__ldg(prev));
    return acc + static_cast<uint32_t>(d < 0 ? -d : d);
}

template <int VEC>
__global__ void __launch_bounds__(256)
sad_block_kernel(const uint8_t* __restrict__ luma, int height, int width,
                 int block, int gh, int gw, int32_t* __restrict__ grid) {
    const int b = blockIdx.x;   // output frame: cur = b + 1, prev = b
    const int by = blockIdx.y;  // block row
    const size_t plane = static_cast<size_t>(height) * width;
    const uint8_t* prev = luma + static_cast<size_t>(b) * plane;
    const uint8_t* cur = prev + plane;
    const int r0 = by * block;
    const int r1 = min(r0 + block, height);
    const int tpb = block / VEC;  // threads per block column, divides 32
    const int units = (width + VEC - 1) / VEC;
    int32_t* out = grid + (static_cast<size_t>(b) * gh + by) * gw;

    // base is uniform across the CTA, so every lane of a warp runs the
    // same iterations and reaches each shuffle
    for (int base = 0; base < units; base += blockDim.x) {
        const int u = base + threadIdx.x;
        uint32_t sum = 0;
        if (u < units) {
            const size_t x = static_cast<size_t>(u) * VEC;
#pragma unroll 4
            for (int r = r0; r < r1; ++r) {
                const size_t off = static_cast<size_t>(r) * width + x;
                sum = unit_sad<VEC>(cur + off, prev + off, sum);
            }
        }
        // lanes of one block column are tpb consecutive lanes, aligned to
        // tpb, because base is a multiple of 32 and tpb divides 32
        for (int d = tpb / 2; d > 0; d >>= 1)
            sum += __shfl_down_sync(kFullMask, sum, d, tpb);
        if (u < units && u % tpb == 0)
            out[u / tpb] = static_cast<int32_t>(sum);
    }
}

template <int VEC>
void launch(const void* luma, int batch, int height, int width, int block,
            int gh, int gw, void* grid, cudaStream_t stream) {
    const int units = (width + VEC - 1) / VEC;
    const int threads = std::min(256, (units + 31) / 32 * 32);
    sad_block_kernel<VEC><<<dim3(batch, gh), threads, 0, stream>>>(
        static_cast<const uint8_t*>(luma), height, width, block, gh, gw,
        static_cast<int32_t*>(grid));
}

}  // namespace

// Launches on `stream` of `device` (made current only where it is not) and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for
// arguments the kernel does not take.  vec is the bytes per load (16, 4 or
// 1), chosen by the caller so that it divides the width and the block size
// and the base address is vec-aligned; block / vec must be a power of two no
// larger than 32.
extern "C" int mvt_sad_block_grid(const void* luma, int batch, int height,
                                  int width, int block, int gh, int gw,
                                  int vec, void* grid, int device,
                                  void* stream) {
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
            launch<16>(luma, batch, height, width, block, gh, gw, grid, s);
        else if (vec == 4)
            launch<4>(luma, batch, height, width, block, gh, gw, grid, s);
        else
            launch<1>(luma, batch, height, width, block, gh, gw, grid, s);
    }
    return static_cast<int>(cudaGetLastError());
}
