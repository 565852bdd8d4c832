// The block-level force of kernels B4 (accel_dd.cu) and B4'
// (graded_step_dd.cu): the double-double accelerations of R rows of one
// scenario row, each folded over ascending j.
//
// Warp specialised, as the fp64 graded step B1' (graded_step_f64.cu). The
// block walks the sources in TJ-wide tiles. Its (R / RPT) * TJ compute
// threads each take RPT of the rows against one column of a tile, the RPT
// pair terms interleaved step by step (dd.cuh dd_pair_terms), and write
// them into a ring of NBUF shared term tiles; one fold warp takes the
// tiles in order, and its lane (row, component) adds a tile's terms in
// ascending j into its register pair (dd_fold_add). In kernel B4' the
// compute threads stage each tile's sources in shared memory a tile
// ahead, q_j copied and gm_j formed from the masses once a block, not once
// a pair; in B4, whose gm_j is a table, each pair reads q_j and gm_j.
// Named barriers hand the term tiles to the fold (full, empty) and the
// staged sources to the compute threads; none stops the whole block, so
// the fold of one tile overlaps the terms of the next.
//
// Bound: the fp64 pipe. A pair is 333 fp64 instructions in the SASS
// (scripts/sass_count.py): the pair term 309 (dd.cuh: three subtractions,
// four squares and products, three sums, a root, a product and a division
// in double-double, three products), seven times kernel B1's 46, and the
// fold 8 a term and row component, all of it issued by the one fold warp.
// wgmma and TMA do not apply: there is no fp64 matrix product and a tile
// is a few KB.

#pragma once

#include <cuda_runtime.h>

#include "dd.cuh"

namespace nbody {

// R rows a block, RPT of them a compute thread, TJ columns a tile, NBUF
// term tiles in the ring, MINB blocks a SM asked of ptxas. The rows fall
// in four groups of compute threads, and group g stages value g of a
// tile's sources: coordinate g of q_j, or (g = 3) gm_j.
template <int R_, int RPT_, int TJ_, int NBUF_, int MINB_>
struct DdGeometry {
    static constexpr int R = R_, RPT = RPT_, TJ = TJ_, NBUF = NBUF_,
                         MINB = MINB_;
    static constexpr int NC = R / RPT * TJ;   // compute threads
    static constexpr int THREADS = NC + 32;   // and one fold warp
    // named barriers: term tile buf written (FULL + buf) and folded
    // (EMPTY + buf); a tile's sources staged (SRC, compute threads only)
    static constexpr int BAR_FULL = 1, BAR_EMPTY = 1 + NBUF,
                         BAR_SRC = 1 + 2 * NBUF;
    static_assert(R % RPT == 0 && R / RPT == 4, "four row groups");
    static_assert(NC % 32 == 0, "whole warps");
    static_assert(3 * R <= 32, "one fold lane per row and component");
    static_assert(THREADS <= 1024 && BAR_SRC < 16, "block, barrier limits");
    struct Smem {
        dd qi[3][R];
        dd src[2][4][TJ];                     // x, y, z, gm of a tile
        double term_hi[NBUF][3][R][TJ + 1];   // +1: no bank conflicts
        double term_lo[NBUF][3][R][TJ + 1];
    };
};

// 4 rows a block, one a thread, 64 columns a tile, two blocks a SM: kernel
// B4, and B4' at small n
using DdNarrow = DdGeometry<4, 1, 64, 3, 2>;

// Source j's gm_j as kernel B4 has it, from a table: load(j) reads from
// global memory what gm_j is made of (a Raw), form() makes gm_j of it.
// STAGED: whether a tile's q_j and gm_j are staged in shared memory, gm_j
// formed once a block (B4', whose gm_j is formed from the masses:
// graded_step_dd.cu), or read by each pair (B4, where staging buys nothing
// and its barrier among the compute warps cost 9% at n = 1024 and 16384
// on an "NVIDIA H100 80GB HBM3, 700.00 W").
struct DdGmTable {
    static constexpr bool STAGED = false;
    using Raw = dd;
    const dd* __restrict__ gm;
    __device__ __forceinline__ Raw load(int j) const { return gm[j]; }
    __device__ __forceinline__ dd form(Raw g) const { return g; }
};

__device__ __forceinline__ void dd_bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void dd_bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The block force of rows i0 .. i0 + R - 1 of the scenario row whose
// positions are qb (n, 3), in three parts. Every thread of the block calls
// dd_rows_qi; then the compute threads (threadIdx.x < NC) dd_rows_terms,
// and the fold warp dd_rows_fold.

// The block's rows into shared memory (a row past n reads as 0)
template <class Geo>
__device__ __forceinline__ void dd_rows_qi(const dd* __restrict__ qb, int n,
                                           int i0, typename Geo::Smem& sm) {
    const int tid = threadIdx.x;
    if (tid < 3 * Geo::R) {
        const int r = tid / 3, c = tid % 3;
        sm.qi[c][r] = i0 + r < n ? qb[static_cast<size_t>(i0 + r) * 3 + c]
                                 : dd{0.0, 0.0};
    }
    __syncthreads();
}

// A compute thread: rows g * RPT .. g * RPT + RPT - 1 against column jj of
// every tile, into the term ring; gms gives the sources' gm (DdGmTable or
// alike)
template <class Geo, class Gms>
__device__ __forceinline__ void dd_rows_terms(const dd* __restrict__ qb,
                                              int n, dd eps2, const Gms& gms,
                                              typename Geo::Smem& sm) {
    constexpr int TJ = Geo::TJ, RPT = Geo::RPT, NBUF = Geo::NBUF;
    const int g = threadIdx.x / TJ, jj = threadIdx.x % TJ;
    const int tiles = (n + TJ - 1) / TJ;
    dd xi[RPT], yi[RPT], zi[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        xi[k] = sm.qi[0][g * RPT + k];
        yi[k] = sm.qi[1][g * RPT + k];
        zi[k] = sm.qi[2][g * RPT + k];
    }
    // the pair terms of column j of tile k, into term tile buf
    auto terms = [&](int buf, dd xj, dd yj, dd zj, dd gmj) {
        dd t[RPT][3];
        dd_pair_terms<RPT>(xj, yj, zj, gmj, xi, yi, zi, eps2, t);
#pragma unroll
        for (int k2 = 0; k2 < RPT; ++k2)
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                sm.term_hi[buf][c][g * RPT + k2][jj] = t[k2][c].hi;
                sm.term_lo[buf][c][g * RPT + k2][jj] = t[k2][c].lo;
            }
    };
    if constexpr (!Gms::STAGED) {
        // each pair reads q_j and gm_j from global memory (the L1 cache
        // holds the tile), and no barrier ties the compute warps together
        for (int k = 0; k < tiles; ++k) {
            const int buf = k % NBUF, j = k * TJ + jj;
            if (k >= NBUF) dd_bar_sync(Geo::BAR_EMPTY + buf, Geo::THREADS);
            if (j < n) {
                const dd* qj = qb + static_cast<size_t>(j) * 3;
                terms(buf, qj[0], qj[1], qj[2], gms.form(gms.load(j)));
            }
            dd_bar_arrive(Geo::BAR_FULL + buf, Geo::THREADS);
        }
    } else {
        // value g of column jj of each tile, read from global memory two
        // tiles ahead and staged in shared memory one tile ahead
        dd rq{0.0, 0.0};
        typename Gms::Raw rg{};
        auto load = [&](int k) {
            const int j = k * TJ + jj;
            if (j >= n) return;
            if (g < 3)
                rq = qb[static_cast<size_t>(j) * 3 + g];
            else
                rg = gms.load(j);
        };
        auto stage = [&](int k) {
            if (k * TJ + jj < n)
                sm.src[k & 1][g][jj] = g < 3 ? rq : gms.form(rg);
        };
        load(0);
        stage(0);
        if (tiles > 1) load(1);
        dd_bar_sync(Geo::BAR_SRC, Geo::NC);
        for (int k = 0; k < tiles; ++k) {
            // src[k & 1] holds tile k; src[(k + 1) & 1] was last read in
            // iteration k - 1, before the barrier that ended it
            if (k + 1 < tiles) stage(k + 1);
            if (k + 2 < tiles) load(k + 2);
            const int buf = k % NBUF;
            if (k >= NBUF) dd_bar_sync(Geo::BAR_EMPTY + buf, Geo::THREADS);
            if (k * TJ + jj < n) {
                const dd(&s)[4][TJ] = sm.src[k & 1];
                terms(buf, s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
            }
            dd_bar_arrive(Geo::BAR_FULL + buf, Geo::THREADS);
            if (k + 1 < tiles) dd_bar_sync(Geo::BAR_SRC, Geo::NC);
        }
    }
}

// Whether this fold-warp thread folds a row component of a live row of the
// block whose first row is i0; x: the index (i0 + row) * 3 + component
template <class Geo>
__device__ __forceinline__ bool dd_fold_lane(int i0, int n, size_t& x) {
    const int lane = static_cast<int>(threadIdx.x) - Geo::NC, fr = lane / 3;
    x = static_cast<size_t>(i0 + fr) * 3 + lane % 3;
    return lane < 3 * Geo::R && i0 + fr < n;
}

// The fold warp: lane (row, component) adds the component's terms over
// ascending j and returns the sum where `folds` (dd_fold_lane)
template <class Geo>
__device__ __forceinline__ dd dd_rows_fold(int n, bool folds,
                                           typename Geo::Smem& sm) {
    constexpr int TJ = Geo::TJ, NBUF = Geo::NBUF;
    const int lane = threadIdx.x - Geo::NC, fr = lane / 3, fc = lane % 3;
    const int tiles = (n + TJ - 1) / TJ;
    dd acc{0.0, 0.0};
    for (int k = 0; k < tiles; ++k) {
        const int buf = k % NBUF;
        const int cols = min(TJ, n - k * TJ);
        dd_bar_sync(Geo::BAR_FULL + buf, Geo::THREADS);
        if (folds) {
            const double* th = sm.term_hi[buf][fc][fr];
            const double* tl = sm.term_lo[buf][fc][fr];
#pragma unroll 4
            for (int jj = 0; jj < cols; ++jj)
                dd_fold_add(acc, dd{th[jj], tl[jj]});
        }
        if (k + NBUF < tiles)
            dd_bar_arrive(Geo::BAR_EMPTY + buf, Geo::THREADS);
    }
    return dd_fold_end(acc);
}

}  // namespace nbody
