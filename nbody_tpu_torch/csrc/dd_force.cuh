// The block-level force of kernels B4 (accel_dd.cu) and B4'
// (graded_step_dd.cu): the double-double accelerations of DD_R rows of one
// scenario row, each folded over ascending j.
//
// Warp specialised, as the fp64 graded step B1' (graded_step_f64.cu):
// DD_R * DD_TJ compute threads, one per (row, column) of a DD_TJ-wide
// source tile, write the tile's pair terms (dd.cuh dd_pair_term) into a
// ring of DD_NBUF shared term tiles; one fold warp takes the tiles in
// order, and its lane (row, component) adds a tile's terms in ascending j
// into its register pair (dd_fold_add). Named barriers hand the tiles over,
// so the fold of one tile overlaps the terms of the next ones.
//
// Bound: the fp64 pipe. A pair term is about 330 fp64 instructions
// (dd.cuh: three subtractions, four squares and products, three sums, a
// root, a product and a division in double-double, three products), seven
// times kernel B1's 46; the fold is eight a term and row component with
// one add of latency, so at n = 1024 the terms, not the fold's chain, set
// the time. wgmma and TMA do not apply: there is no fp64 matrix product
// and a tile is a few KB.

#pragma once

#include <cuda_runtime.h>

#include "dd.cuh"

namespace nbody {

constexpr int DD_R = 4;                  // rows per block
constexpr int DD_TJ = 64;                // columns per tile
constexpr int DD_NBUF = 3;               // term tiles in flight
constexpr int DD_NC = DD_R * DD_TJ;      // compute threads
constexpr int DD_THREADS = DD_NC + 32;   // and one fold warp
constexpr int DD_BAR_FULL = 1;               // named barriers: buf written
constexpr int DD_BAR_EMPTY = 1 + DD_NBUF;    // buf folded
static_assert(2 * DD_NBUF < 16, "named barriers 1..15");
static_assert(3 * DD_R <= 32, "one fold lane per row and component");

struct DdRowsSmem {
    dd qi[3][DD_R];
    double term_hi[DD_NBUF][3][DD_R][DD_TJ + 1];   // +1: no bank conflicts
    double term_lo[DD_NBUF][3][DD_R][DD_TJ + 1];
};

__device__ __forceinline__ void dd_bar_sync(int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(DD_THREADS) : "memory");
}
__device__ __forceinline__ void dd_bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(DD_THREADS)
                 : "memory");
}

// Rows i0 .. i0 + DD_R - 1 of the scenario row whose positions are qb
// (n, 3); gm(j) gives source j's G * m_eff. Every thread of the block
// calls it. On the fold lanes that own a row and component it returns
// true, with the component's sum in `acc` and its index (i0 + row) * 3 +
// component in `x`.
template <typename Gm>
__device__ __forceinline__ bool dd_rows_accel(const dd* __restrict__ qb,
                                              int n, int i0, dd eps2, Gm gm,
                                              DdRowsSmem& sm, dd& acc,
                                              size_t& x) {
    const int tid = threadIdx.x;
    if (tid < 3 * DD_R) {
        const int r = tid / 3, c = tid % 3;
        sm.qi[c][r] = i0 + r < n ? qb[static_cast<size_t>(i0 + r) * 3 + c]
                                 : dd{0.0, 0.0};
    }
    __syncthreads();

    const int tiles = (n + DD_TJ - 1) / DD_TJ;
    if (tid < DD_NC) {
        // compute threads: the pair (row r, column jj) of every tile
        const int r = tid / DD_TJ, jj = tid % DD_TJ;
        const dd xi = sm.qi[0][r], yi = sm.qi[1][r], zi = sm.qi[2][r];
        const bool live = i0 + r < n;
        for (int k = 0; k < tiles; ++k) {
            const int buf = k % DD_NBUF;
            if (k >= DD_NBUF) dd_bar_sync(DD_BAR_EMPTY + buf);
            const int j = k * DD_TJ + jj;
            if (live && j < n) {
                const dd* qj = qb + static_cast<size_t>(j) * 3;
                dd t[3];
                dd_pair_term(qj[0], qj[1], qj[2], gm(j), xi, yi, zi, eps2,
                             t[0], t[1], t[2]);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    sm.term_hi[buf][c][r][jj] = t[c].hi;
                    sm.term_lo[buf][c][r][jj] = t[c].lo;
                }
            }
            dd_bar_arrive(DD_BAR_FULL + buf);
        }
        return false;
    }
    // the fold warp: lane (fr, fc) folds component fc of row fr
    const int lane = tid - DD_NC, fr = lane / 3, fc = lane % 3;
    const bool folds = lane < 3 * DD_R && i0 + fr < n;
    acc = dd{0.0, 0.0};
    for (int k = 0; k < tiles; ++k) {
        const int buf = k % DD_NBUF;
        const int cols = min(DD_TJ, n - k * DD_TJ);
        dd_bar_sync(DD_BAR_FULL + buf);
        if (folds) {
            const double* th = sm.term_hi[buf][fc][fr];
            const double* tl = sm.term_lo[buf][fc][fr];
#pragma unroll 4
            for (int jj = 0; jj < cols; ++jj)
                dd_fold_add(acc, dd{th[jj], tl[jj]});
        }
        if (k + DD_NBUF < tiles) dd_bar_arrive(DD_BAR_EMPTY + buf);
    }
    acc = dd_fold_end(acc);
    x = static_cast<size_t>(i0 + fr) * 3 + fc;
    return folds;
}

}  // namespace nbody
