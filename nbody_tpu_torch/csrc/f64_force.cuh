// The block-level force of the binary64 kernels: kernel B1 (accel_f64.cu),
// the graded step B1' (graded_step_f64.cu) and simulate's step
// (sim_step_f64.cu). A block computes the accelerations of R rows of one
// scenario row, each component folded over ascending j, bit for bit what
// kernel B1's plain twin computes (forces.cuh b1_pair_term, then
// acc = __dadd_rn(acc, term) for j = 0, 1, ..., n-1 from acc = +0).
//
// Warp specialised. The block walks the sources in TJ-wide tiles. Its
// R * TJ compute threads each take one (row, column) pair of every tile and
// write the pair's three terms into a ring of NBUF shared term tiles; one
// fold warp takes the tiles in order, and its lane (row, component) adds a
// tile's terms in ascending j into a register. Named barriers hand the term
// tiles over (full[buf] once the compute threads wrote tile buf, empty[buf]
// once the fold warp folded it), so the fold of tile k overlaps the terms
// of the tiles after it and no barrier stops the whole block.
//
// The sources come from an accessor (Src), so that each caller gives them
// as it has them: a table of positions and gm_j (B1 and simulate's mesh
// step; F64Table below), or positions in the mesh's row blocks with gm_j
// formed from the masses (B1'; graded_step_f64.cu), or the positions and
// gm_j of simulate's state (its Blocked step; sim_step_f64.cu). Simulate's
// persistent chunk, which writes its sources between steps, reads them
// with plain loads a tile ahead (f64_rows_terms_ahead). B1''s launch-a-step
// path and simulate's Blocked step have compute threads of their own
// (F64Producer below): several rows a thread, the source (and B1''s
// masses) a tile ahead, zero numerators without the slow-path call; and a
// fold loop whose tile is unrolled (f64_rows_fold_tiles), the same sums.
//
// Bound: the fp64 pipe and the fold's latency. A pair costs 40 fp64
// instructions in the SASS (scripts/sass_count.py), a square root and one
// reciprocal that its three divisions share among them, which the compute
// threads issue; a row component is a chain of n dependent adds (about 9.5
// cycles each on the card, chip_smoke.py phase 2's fold floor), which no
// reassociation may shorten, run in parallel over the lanes of the fold
// warp and over the blocks an SM holds. Kernel B1 (the seed of
// simulate's leapfrog, the mesh's cross form) and simulate's persistent
// chunk keep one geometry, F64Block. On B1''s graded step and on
// simulate's Blocked step (65536 rows at the benchmark's binary64 cell)
// this producer fell behind its fold and its fold loop ran at twice the
// adds' latency (PERF.md section 6), which F64Producer and
// f64_rows_fold_tiles repair, in geometries chosen by shape: the Blocked
// step's wide blocks give the fold more lanes, 3 a row. wgmma and TMA do
// not apply: there is no fp64 matrix product here and a tile is a few
// KB.

#pragma once

#include <cuda_runtime.h>

#include "blocks.cuh"
#include "forces.cuh"

namespace nbody {

// R rows a block, TJ columns a tile, NBUF term tiles in the ring, MINB
// blocks an SM asked of ptxas
template <int R_, int TJ_, int NBUF_, int MINB_>
struct F64Geometry {
    static constexpr int R = R_, TJ = TJ_, NBUF = NBUF_, MINB = MINB_;
    static constexpr int NC = R * TJ;          // compute threads
    static constexpr int THREADS = NC + 32;    // and one fold warp
    // named barriers: term tile buf written (FULL + buf), folded (EMPTY +
    // buf)
    static constexpr int BAR_FULL = 1, BAR_EMPTY = 1 + NBUF;
    static_assert(NC % 32 == 0, "whole warps");
    static_assert(3 * R <= 32, "one fold lane per row and component");
    static_assert(THREADS <= 1024 && BAR_EMPTY + NBUF <= 16,
                  "block, barrier limits");
    struct Smem {
        double qi[3][R];
        double term[NBUF][3][R][TJ + 1];   // +1: no bank conflicts
    };
};

// 4 rows a block, 256 blocks a scenario row of 1024 bodies: kernel B1 and
// simulate's persistent chunk (up to 512 rows). At n = 16384 rows, 8 rows
// a block with two a compute thread was 12% faster on an "NVIDIA H100
// 80GB HBM3, 700.00 W" (PERF.md); the paths that run that many rows,
// simulate's Blocked step above 512 bodies (65536 rows at the benchmark's
// binary64 cell), take F64Producer's geometries (sim_step_f64.cu).
using F64Block = F64Geometry<4, 64, 4, 2>;

// Kernel B1's sources: positions q (n, 3) and gm (n,), read a pair (the L1
// cache holds a tile)
struct F64Table {
    const double* __restrict__ q;
    const double* __restrict__ gm;
    struct Cursor {};
    __device__ __forceinline__ Cursor cursor(int) const { return {}; }
    __device__ __forceinline__ const double* pos(Cursor&, int j) const {
        return q + 3LL * j;
    }
    __device__ __forceinline__ double gm_of(int j) const { return gm[j]; }
};

__device__ __forceinline__ void f64_bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void f64_bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The block force of the `live` rows at qi (R at most, (live, 3)) against
// the n sources of src, in three parts: every thread of the block calls
// f64_rows_qi; then the compute threads (threadIdx.x < NC) f64_rows_terms,
// and the fold warp f64_rows_fold.

// The block's rows into shared memory (a row past `live` reads as 0)
template <class Geo>
__device__ __forceinline__ void f64_rows_qi(const double* qi, int live,
                                            typename Geo::Smem& sm) {
    const int tid = threadIdx.x;
    if (tid < 3 * Geo::R) {
        const int r = tid / 3, c = tid % 3;
        sm.qi[c][r] = r < live ? qi[3 * r + c] : 0.0;
    }
    __syncthreads();
}

// A compute thread: row g against column jj of every tile, into the term
// ring
template <class Geo, int dist3, class Src>
__device__ __forceinline__ void f64_rows_terms(const Src& src, int n,
                                               int live, double eps2,
                                               typename Geo::Smem& sm) {
    constexpr int TJ = Geo::TJ, NBUF = Geo::NBUF;
    const int g = threadIdx.x / TJ, jj = threadIdx.x % TJ;
    const int tiles = (n + TJ - 1) / TJ;
    auto cur = src.cursor(jj);
    const double xi = sm.qi[0][g], yi = sm.qi[1][g], zi = sm.qi[2][g];
    const bool row_live = g < live;
    for (int k = 0; k < tiles; ++k) {
        const int buf = k % NBUF;
        if (k >= NBUF) f64_bar_sync(Geo::BAR_EMPTY + buf, Geo::THREADS);
        const int j = k * TJ + jj;
        if (row_live && j < n) {
            const double* qj = src.pos(cur, j);
            b1_pair_term<dist3>(qj[0], qj[1], qj[2], src.gm_of(j), xi, yi,
                                zi, eps2, sm.term[buf][0][g][jj],
                                sm.term[buf][1][g][jj],
                                sm.term[buf][2][g][jj]);
        }
        f64_bar_arrive(Geo::BAR_FULL + buf, Geo::THREADS);
    }
}

// Source j of positions q (n, 3) and gm (n,) as a compute thread holds it,
// or zeros past n. Plain loads, no __restrict__: simulate's persistent
// chunk (sim_step.cuh) writes q and gm between its steps, and a load the
// compiler may take as read-only for the kernel's life (ld.global.nc)
// could return the value of the step before.
struct F64Src {
    double x, y, z, gm;
    __device__ __forceinline__ static F64Src at(const double* q,
                                                const double* gm, int j,
                                                int n) {
        if (j >= n) return {0.0, 0.0, 0.0, 0.0};
        return {q[3LL * j], q[3LL * j + 1], q[3LL * j + 2], gm[j]};
    }
};

// f64_rows_terms over sources q (n, 3) and gm (n,) that the caller's
// kernel writes (simulate's persistent chunk), each tile's source loaded
// into registers a tile ahead, so that its latency (an L2 access: other
// blocks wrote it in the step before) runs under the tile before; `cur`:
// tile 0's source of this thread's column, F64Src::at(q, gm, jj, n), which
// the caller loads before f64_rows_qi so that the two loads overlap. The
// terms, and so the bits, are f64_rows_terms's. On an H100 it took a
// persistent chunk's step from 3.105 to 3.012 us at n = 20, 4.867 to
// 4.766 at 256, 7.049 to 6.978 at 512 (PERF.md).
template <class Geo, int dist3>
__device__ __forceinline__ void f64_rows_terms_ahead(const double* q,
                                                     const double* gm, int n,
                                                     int live, double eps2,
                                                     typename Geo::Smem& sm,
                                                     F64Src cur) {
    constexpr int TJ = Geo::TJ, NBUF = Geo::NBUF;
    const int g = threadIdx.x / TJ, jj = threadIdx.x % TJ;
    const int tiles = (n + TJ - 1) / TJ;
    const double xi = sm.qi[0][g], yi = sm.qi[1][g], zi = sm.qi[2][g];
    const bool row_live = g < live;
    for (int k = 0; k < tiles; ++k) {
        const int buf = k % NBUF;
        const int j = k * TJ + jj;
        const F64Src next = F64Src::at(q, gm, j + TJ, n);
        if (k >= NBUF) f64_bar_sync(Geo::BAR_EMPTY + buf, Geo::THREADS);
        if (row_live && j < n)
            b1_pair_term<dist3>(cur.x, cur.y, cur.z, cur.gm, xi, yi, zi,
                                eps2, sm.term[buf][0][g][jj],
                                sm.term[buf][1][g][jj],
                                sm.term[buf][2][g][jj]);
        f64_bar_arrive(Geo::BAR_FULL + buf, Geo::THREADS);
        cur = next;
    }
}

// B1''s producer on the graded launch-a-step path (graded_step_f64.cu)
// and simulate's Blocked step (sim_step_f64.cu), the compute threads'
// half of the block force above in another form: R
// rows a block, RT of them a compute thread, TJ columns a tile, NBUF term
// tiles in the ring, MINB blocks an SM asked of ptxas. The fold warp, the
// term ring and its barriers are F64Geometry's (f64_rows_qi serves both;
// the fold warp's loop is f64_rows_fold_tiles).
template <int R_, int RT_, int TJ_, int NBUF_, int MINB_>
struct F64Producer {
    static constexpr int R = R_, RT = RT_, TJ = TJ_, NBUF = NBUF_,
                         MINB = MINB_;
    static constexpr int NC = R / RT * TJ;     // compute threads
    static constexpr int THREADS = NC + 32;    // and one fold warp
    static constexpr int BAR_FULL = 1, BAR_EMPTY = 1 + NBUF;
    static_assert(R % RT == 0 && NC % 32 == 0 && TJ % 32 == 0,
                  "whole warps, a warp's columns of one row group");
    static_assert(3 * R <= 32, "one fold lane per row and component");
    static_assert(THREADS <= 1024 && BAR_EMPTY + NBUF <= 16,
                  "block, barrier limits");
    struct Smem {
        double qi[3][R];
        double term[NBUF][3][R][TJ + 1];   // +1: no bank conflicts
    };
};

// F64Producer's compute thread (g, jj): rows g, g + R / RT, ... of the
// block against column jj of every tile, into the term ring. Src gives a
// source as the thread holds it (Src::Source, src.at(cur, j, n): zeros
// past n) and its gm_j (src.gm); cur and s: the thread's cursor and tile
// 0's source (src.at at jj), which the caller loads before the block's
// set-up so that its latency runs under it. Each tile's source is loaded
// into registers a tile ahead and its gm_j formed where the pairs take it
// (graded_gm's bits, once a thread and tile: once a block where RT = R);
// its RT pairs' terms (forces.cuh b1_pair_terms) are b1_pair_term's,
// whichever thread makes them.
template <class Geo, int dist3, class Src>
__device__ __forceinline__ void f64_rows_terms_rt(
        const Src& src, typename Src::Cursor& cur, typename Src::Source s,
        int n, int live, double eps2, typename Geo::Smem& sm) {
    constexpr int TJ = Geo::TJ, NBUF = Geo::NBUF, RT = Geo::RT;
    constexpr int RG = Geo::R / RT;   // a row group's stride
    const int g = threadIdx.x / TJ, jj = threadIdx.x % TJ;
    const int tiles = (n + TJ - 1) / TJ;
    double xi[RT], yi[RT], zi[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
        xi[k] = sm.qi[0][g + k * RG];
        yi[k] = sm.qi[1][g + k * RG];
        zi[k] = sm.qi[2][g + k * RG];
    }
    for (int k = 0; k < tiles; ++k) {
        const int buf = k % NBUF;
        const int j = k * TJ + jj;
        const typename Src::Source next = src.at(cur, j + TJ, n);
        if (k >= NBUF) f64_bar_sync(Geo::BAR_EMPTY + buf, Geo::THREADS);
        if (g < live && j < n) {
            double t[RT][3];
            b1_pair_terms<dist3, RT>(s.x, s.y, s.z, src.gm(s), xi, yi, zi,
                                     eps2, t);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                if (g + r * RG < live) {
                    sm.term[buf][0][g + r * RG][jj] = t[r][0];
                    sm.term[buf][1][g + r * RG][jj] = t[r][1];
                    sm.term[buf][2][g + r * RG][jj] = t[r][2];
                }
            }
        }
        f64_bar_arrive(Geo::BAR_FULL + buf, Geo::THREADS);
        s = next;
    }
}

// F64Producer's fold warp: f64_rows_fold's sum, in its order, with a
// whole tile's adds unrolled, so that the loads of a tile's terms run
// ahead of its chain of adds where a loop of runtime length waits for
// each group of them
template <class Geo>
__device__ __forceinline__ double f64_rows_fold_tiles(int n, bool folds,
                                                      typename Geo::Smem& sm) {
    constexpr int TJ = Geo::TJ, NBUF = Geo::NBUF;
    const int lane = threadIdx.x - Geo::NC, fr = lane / 3, fc = lane % 3;
    const int tiles = (n + TJ - 1) / TJ;
    double acc = 0.0;
    for (int k = 0; k < tiles; ++k) {
        const int buf = k % NBUF;
        const int cols = min(TJ, n - k * TJ);
        f64_bar_sync(Geo::BAR_FULL + buf, Geo::THREADS);
        if (folds) {
            const double* term = sm.term[buf][fc][fr];
            if (cols == TJ) {
#pragma unroll
                for (int jj = 0; jj < TJ; ++jj)
                    acc = __dadd_rn(acc, term[jj]);
            } else {
                for (int jj = 0; jj < cols; ++jj)
                    acc = __dadd_rn(acc, term[jj]);
            }
        }
        if (k + NBUF < tiles)
            f64_bar_arrive(Geo::BAR_EMPTY + buf, Geo::THREADS);
    }
    return acc;
}

// Whether this fold-warp thread folds a row component of one of the
// block's `live` rows; x: the index row * 3 + component from the block's
// first row
template <class Geo>
__device__ __forceinline__ bool f64_fold_lane(int live, int& x) {
    const int lane = static_cast<int>(threadIdx.x) - Geo::NC, fr = lane / 3;
    x = 3 * fr + lane % 3;
    return lane < 3 * Geo::R && fr < live;
}

// The fold warp: lane (row, component) adds the component's n terms over
// ascending j from +0 and returns the sum where `folds` (f64_fold_lane)
template <class Geo>
__device__ __forceinline__ double f64_rows_fold(int n, bool folds,
                                                typename Geo::Smem& sm) {
    constexpr int TJ = Geo::TJ, NBUF = Geo::NBUF;
    const int lane = threadIdx.x - Geo::NC, fr = lane / 3, fc = lane % 3;
    const int tiles = (n + TJ - 1) / TJ;
    double acc = 0.0;
    for (int k = 0; k < tiles; ++k) {
        const int buf = k % NBUF;
        const int cols = min(TJ, n - k * TJ);
        f64_bar_sync(Geo::BAR_FULL + buf, Geo::THREADS);
        if (folds) {
            const double* term = sm.term[buf][fc][fr];
#pragma unroll 8
            for (int jj = 0; jj < cols; ++jj) acc = __dadd_rn(acc, term[jj]);
        }
        if (k + NBUF < tiles)
            f64_bar_arrive(Geo::BAR_EMPTY + buf, Geo::THREADS);
    }
    return acc;
}

// What the card says of a kernel of geometry Geo: out = {registers, local
// bytes, threads, resident blocks an SM, rows a block (forces.cuh
// kernel_info), columns a tile, NBODY_SHARED_RCP (forces.cuh)}. Returns
// the CUDA error, or 0.
template <class Geo, class Kernel>
int f64_kernel_info(Kernel* kernel, int* out) {
    const int err = kernel_info(kernel, Geo::THREADS, Geo::R, out);
    if (err != 0) return err;
    out[5] = Geo::TJ;
    out[6] = NBODY_SHARED_RCP;
    return 0;
}

}  // namespace nbody
