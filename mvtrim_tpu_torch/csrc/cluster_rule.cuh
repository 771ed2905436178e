// The vote-level cluster rule, shared by cluster_map.cu and mv_cluster.cu.
//
// For each centre cell of a [gh, gw] vote grid, y in [y_min, y_max) and x in
// [1, gw-2]:
//
//   counts  when  min(v, max(left, right, up, down)) >= thr
//
// which is "v >= thr and some 4-neighbour >= thr".  A neighbour outside the
// grid reads as vote 0 and is compared with thr like any other cell, so at
// thr <= 0 it is active (what _shift2d's zero fill and the NumPy oracle do).
// Left and right of a centre cell always lie in the grid; up and down may not
// when the vertical margin is 0.
//
// `vote(i)` reads the vote at flat index i = y * gw + x.  The calling thread
// visits the centre cells first, first + stride, ... in row order and returns
// how many of them count; the caller sums over its threads.

#pragma once

#include <cstdint>

template <typename Vote>
__device__ __forceinline__ uint32_t count_cluster_cells(
        Vote vote, int gh, int gw, int y_min, int y_max, int thr, int first,
        int stride) {
    const int y0 = max(y_min, 0);
    const int rows = min(y_max, gh) - y0;
    const int cols = gw - 2;  // centre columns x = 1 .. gw-2
    const int cells = rows > 0 && cols > 0 ? rows * cols : 0;
    uint32_t total = 0;
    for (int j = first; j < cells; j += stride) {
        const int y = y0 + j / cols;
        const int x = 1 + j % cols;
        const int i = y * gw + x;
        const int v = vote(i);
        const int left = vote(i - 1);
        const int right = vote(i + 1);
        const int up = y > 0 ? vote(i - gw) : 0;
        const int down = y + 1 < gh ? vote(i + gw) : 0;
        const int nmax = max(max(left, right), max(up, down));
        total += min(v, nmax) >= thr ? 1u : 0u;
    }
    return total;
}
