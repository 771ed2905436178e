// K4+K5's keep rule for one MV, shared by mv_cluster.cu (K4+K5) and
// bench_controls.cu (C5, C9), so its traps live in one place, and the
// shared-memory layout K4+K5 and C5 share:
//
//   keep  when  mag >= bound  and  0 <= gx < gw  and  y_lo <= gy < y_hi
//
// with mag = dx*dx + dy*dy wrapped to int32 as the reference's `int` does
// (|dx| reaches 65535 for int16 fields, so the square is formed in uint32,
// where wrapping is defined, and read back as int32), gx, gy the arithmetic
// right shifts of dst (floor for a negative dst, which then falls off the
// grid), and [y_lo, y_hi) the vote window's rows inside the grid,
// [max(y_min, 0), min(y_max, gh)).

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace mvt {

// Rows of the vote window, inside the grid.
__host__ __device__ __forceinline__ int window_lo(int y_min) {
    return y_min > 0 ? y_min : 0;
}
__host__ __device__ __forceinline__ int window_rows(int gh, int y_min,
                                                    int y_max) {
    const int hi = y_max < gh ? y_max : gh;
    return hi > window_lo(y_min) ? hi - window_lo(y_min) : 0;
}

// The shared memory of a kernel that packs the window's rows into words
// beside a 32-bit vote histogram (K4+K5, C5): the 32 warp sums, the words
// padded to 16 bytes, then the histogram where it lives there.  32-bit
// words before the histogram:
__host__ __device__ __forceinline__ int words_before_hist(int rows, int gw) {
    return (32 + rows * ((gw + 31) / 32) + 3) & ~3;
}

// That shared memory in bytes, with or without the histogram.
inline size_t hist_shared_bytes(int rows, int gw, bool with_hist) {
    size_t words = static_cast<size_t>(words_before_hist(rows, gw));
    if (with_hist) words += static_cast<size_t>(rows) * gw;
    return words * sizeof(uint32_t);
}

// Whether K4+K5's rule keeps an MV, and its cell: row r of the window
// [y_lo, y_hi) and column gx.
__device__ __forceinline__ bool kept_cell(short4 mv, long long bound,
                                          int shift, int gw, int y_lo,
                                          int y_hi, int& r, int& gx) {
    const int dst_x = mv.x, dst_y = mv.y;  // widened before the shift
    const uint32_t dx = static_cast<uint32_t>(dst_x - mv.z);
    const uint32_t dy = static_cast<uint32_t>(dst_y - mv.w);
    const int mag = static_cast<int>(dx * dx + dy * dy);
    gx = dst_x >> shift;
    const int gy = dst_y >> shift;
    r = gy - y_lo;
    return mag >= bound && gx >= 0 && gx < gw && gy >= y_lo && gy < y_hi;
}

}  // namespace mvt
