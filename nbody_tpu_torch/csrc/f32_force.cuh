// The block-level force of kernel B2 (accel_f32.cu), shared with
// simulate's float32 step (sim_step_f32.cu) so that the two give the same
// bits: the float32 accelerations of RB rows of one scenario row against
// nj sources, each component the sum over 128-wide source tiles, each
// tile folded from 0 in ascending j, the tile sums added from 0 in
// ascending tile order.
//
// A block owns RB = R * LR rows and walks the sources in rounds of TPR
// tiles. A thread owns R rows and, in a round, one tile: it folds that
// tile's pair terms for its R rows (one staged source feeds R terms). The
// LR lanes of a warp that share a tile read the same staged source (a
// broadcast); a warp folds 32 / LR tiles at once, and the W warps of the
// block fold the rest of the round's tiles. The tile sums go through
// shared memory, and one owner thread per (row, component) adds them to
// its register in ascending tile order. The next round's sources are
// copied into the other half of a 2-deep shared ring with cp.async while
// the current round is folded; one barrier a round. The last tile is
// folded only to its end, so any ni and nj work unpadded. There are no
// atomics: the result is bitwise the same from run to run.
//
// Two shapes keep the card full (accel_f32.cu has the bound): B2Large
// (R = 4, LR = 32, W = 4: 128 rows a block) serves ni in the tens of
// thousands, where every block rereads all of qj from L2; B2Small (R = 2,
// LR = 8, W = 2: 16 rows a block, 8 tiles a round) splits ni = 1024 into
// 64 blocks a batch row. No sum depends on the shape.

#pragma once

#include <cuda_runtime.h>

#include "forces.cuh"

namespace nbody {

constexpr int B2_TJ = 128;               // sources a tile: the TPU kernel's
constexpr int B2_STRIDE = B2_TJ + 2;     // float4s between staged tiles: the
                                         // LR lanes of each tile land on
                                         // other banks
// the large shape is taken when its grid has at least this many blocks
// (two waves of 132 SMs); below it, the small one
constexpr int B2_LARGE_MIN_BLOCKS = 264;

template <int R_, int LR_, int W_>
struct B2Shape {
    static constexpr int R = R_;            // rows a thread
    static constexpr int LR = LR_;          // lanes of a warp on one tile
    static constexpr int THREADS = 32 * W_;
    static constexpr int LT = 32 / LR;      // tiles a warp folds in a round
    static constexpr int RB = R * LR;       // rows a block
    static constexpr int TPR = W_ * LT;     // tiles a round
    static constexpr int SPAN = TPR * B2_TJ;   // sources a round
    // (row, component)s a thread owns: o = threadIdx.x + k * THREADS for
    // k < OWN, row o % RB and component o / RB, where o < 3 * RB
    static constexpr int OWN = (3 * RB + THREADS - 1) / THREADS;
    static_assert(32 % LR == 0, "a warp holds whole row groups");
    struct Smem {
        float4 src[2][TPR * B2_STRIDE];
        float part[2][TPR][3][RB];
    };
};

using B2Large = B2Shape<4, 32, 4>;
using B2Small = B2Shape<2, 8, 2>;

// Whether B scenario rows of ni rows take the large shape
inline bool b2_large(int B, int ni) {
    return (ni + (B2Large::RB - 1LL)) / B2Large::RB * B
           >= B2_LARGE_MIN_BLOCKS;
}

// The source tiles of a float32 sum and the order their sums are added
// in. B2Tiles: B2's own, 128-wide tiles from source 0, each tile sum added
// to the row. GroupTiles: the mesh's ordered sum at tile T
// (parallel/sharded.ring_accel_ordered): groups of T sources from 0 (the
// last one ragged), each cut into sub-tiles of 128 from its first source
// (the last ragged at the group's end), each sub-tile folded from 0 and
// its sum added to the group's partial from +0, the group partials added
// to the row from 0 in ascending order. At T = 128 each group is one tile
// and its partial the tile sum (0 + p = p: a tile sum starts at +0 and is
// never -0), so the two sums are one. A tile is a sub-tile below.
struct B2Tiles {
    static constexpr bool grouped = false;
    int nj;
    __device__ __forceinline__ static B2Tiles of(int nj, int) {
        return {nj};
    }
    __device__ __forceinline__ int count() const {
        return (nj + B2_TJ - 1) / B2_TJ;
    }
    __device__ __forceinline__ int start(int s) const { return s * B2_TJ; }
    __device__ __forceinline__ int len(int s) const {
        return min(B2_TJ, nj - s * B2_TJ);
    }
    __device__ __forceinline__ bool ends_group(int) const { return true; }
};

struct GroupTiles {
    static constexpr bool grouped = true;
    int nj, T, U;   // U: the sub-tiles of a whole group, ceil(T / 128)
    __device__ __forceinline__ static GroupTiles of(int nj, int T) {
        return {nj, T, (T + B2_TJ - 1) / B2_TJ};
    }
    __device__ __forceinline__ int count() const {
        const int last = (nj - 1) / T;   // the last group, maybe ragged
        return last * U + (nj - last * T + B2_TJ - 1) / B2_TJ;
    }
    __device__ __forceinline__ int start(int s) const {
        const int g = s / U;
        return g * T + (s - g * U) * B2_TJ;
    }
    // the end of sub-tile s's group (its last sub-tile ends there)
    __device__ __forceinline__ int group_end(int s) const {
        return min((s / U + 1) * T, nj);
    }
    __device__ __forceinline__ int len(int s) const {
        const int j0 = start(s);
        return min(B2_TJ, group_end(s) - j0);
    }
    __device__ __forceinline__ bool ends_group(int s) const {
        return start(s) + B2_TJ >= group_end(s);
    }
};

// Copy the sources [j0, j0 + cnt) of a round into the staged layout: tile
// k of the round at buf[k * B2_STRIDE], one float4 (x, y, z, gm) a source.
template <class S>
__device__ __forceinline__ void b2_stage(float4* buf, const float* qj,
                                         const float* gmj, int j0, int cnt) {
    for (int k = threadIdx.x; k < cnt; k += S::THREADS) {
        float* d = reinterpret_cast<float*>(buf + (k / B2_TJ) * B2_STRIDE
                                            + k % B2_TJ);
        const size_t j = static_cast<size_t>(j0) + k;
        cp_async4(d, qj + j * 3);
        cp_async4(d + 1, qj + j * 3 + 1);
        cp_async4(d + 2, qj + j * 3 + 2);
        cp_async4(d + 3, gmj + j);
    }
}

// Stage round rd's tiles of `tiles` (nsub of them) into buf: tile k of
// the round at buf[k * B2_STRIDE]. B2's tiles are one run of sources; a
// grouped round's tiles go one at a time, each from its own first source.
template <class S, class Tiles>
__device__ __forceinline__ void b2_stage_round(float4* buf, const float* qj,
                                               const float* gmj,
                                               const Tiles& tl, int rd,
                                               int nsub) {
    if constexpr (!Tiles::grouped) {
        const int j0 = rd * S::SPAN;
        b2_stage<S>(buf, qj, gmj, j0, min(S::SPAN, tl.nj - j0));
    } else {
        for (int w = 0; w < S::TPR && rd * S::TPR + w < nsub; ++w) {
            const int s = rd * S::TPR + w;
            b2_stage<S>(buf + w * B2_STRIDE, qj, gmj, tl.start(s), tl.len(s));
        }
    }
}

// The owners' share of a round: each (row, component) adds the round's
// tile sums, in ascending tile order, to its register; in a grouped sum
// to its group partial grp, which goes into acc at the group's end.
template <class S, class Tiles>
__device__ __forceinline__ void b2_add_tile_sums(
        float (*part)[3][S::RB], int round, const Tiles& tl, int nsub,
        float (&acc)[S::OWN], float (&grp)[S::OWN]) {
#pragma unroll
    for (int k = 0; k < S::OWN; ++k) {
        const int o = threadIdx.x + k * S::THREADS;
        if (o < 3 * S::RB)
            for (int tt = 0; tt < S::TPR && round * S::TPR + tt < nsub;
                 ++tt) {
                const float p = part[tt][o / S::RB][o % S::RB];
                if constexpr (!Tiles::grouped) {
                    acc[k] += p;
                } else {
                    grp[k] += p;
                    if (tl.ends_group(round * S::TPR + tt)) {
                        acc[k] += grp[k];
                        grp[k] = 0.0f;
                    }
                }
            }
    }
}

// The block force: the rows i0 .. i0 + RB - 1 (those below ni) of qi
// (ni, 3) against the sources qj (nj, 3) under gmj (nj,), summed over the
// tiles `tl` (B2Tiles or GroupTiles of nj sources); every thread of the
// block calls it. acc[k] ends holding the owned (row, component) k
// (B2Shape::OWN) of the thread. No __restrict__ on the pointers:
// simulate's persistent chunk (sim_step.cuh) writes them between steps,
// so no load of them may take the non-coherent path.
template <class S, class Tiles>
__device__ __forceinline__ void b2_rows_force_tiled(
        const float* qi, int ni, long long i0, const float* qj,
        const float* gmj, const Tiles& tl, float eps2, typename S::Smem& sm,
        float (&acc)[S::OWN]) {
    const int tid = threadIdx.x, lane = tid % 32;
    const int lr = lane % S::LR;
    const int tt = (tid / 32) * S::LT + lane / S::LR;   // tile of the round

    // this thread's rows i0 + r * LR + lr
    float xi[S::R], yi[S::R], zi[S::R];
#pragma unroll
    for (int r = 0; r < S::R; ++r) {
        const long long i = i0 + r * S::LR + lr;
        xi[r] = yi[r] = zi[r] = 0.0f;
        if (i < ni) {
            xi[r] = qi[i * 3];
            yi[r] = qi[i * 3 + 1];
            zi[r] = qi[i * 3 + 2];
        }
    }
    float grp[S::OWN];   // a grouped sum's group partials
#pragma unroll
    for (int k = 0; k < S::OWN; ++k) acc[k] = grp[k] = 0.0f;

    const int nsub = tl.count();
    const int rounds = (nsub - 1) / S::TPR + 1;
    b2_stage_round<S>(sm.src[0], qj, gmj, tl, 0, nsub);
    cp_async_commit();
    for (int rd = 0; rd < rounds; ++rd) {
        cp_async_wait<0>();
        // this round's sources are in; every thread has folded the last
        // round (its half of the ring is free) and written its tile sums
        __syncthreads();
        if (rd + 1 < rounds)
            b2_stage_round<S>(sm.src[(rd + 1) % 2], qj, gmj, tl, rd + 1,
                              nsub);
        cp_async_commit();
        if (rd > 0)
            b2_add_tile_sums<S>(sm.part[(rd - 1) % 2], rd - 1, tl, nsub, acc,
                                grp);

        if (rd * S::TPR + tt < nsub) {
            const int cols = tl.len(rd * S::TPR + tt);
            const float4* src = sm.src[rd % 2] + tt * B2_STRIDE;
            float px[S::R], py[S::R], pz[S::R];
#pragma unroll
            for (int r = 0; r < S::R; ++r) px[r] = py[r] = pz[r] = 0.0f;
#pragma unroll 4
            for (int jj = 0; jj < cols; ++jj) {
                const float4 s = src[jj];
#pragma unroll
                for (int r = 0; r < S::R; ++r) {
                    float tx, ty, tz;
                    b2_pair_term(s, xi[r], yi[r], zi[r], eps2, tx, ty, tz);
                    px[r] += tx;
                    py[r] += ty;
                    pz[r] += tz;
                }
            }
            float (*part)[S::RB] = sm.part[rd % 2][tt];
#pragma unroll
            for (int r = 0; r < S::R; ++r) {
                part[0][r * S::LR + lr] = px[r];
                part[1][r * S::LR + lr] = py[r];
                part[2][r * S::LR + lr] = pz[r];
            }
        }
    }
    __syncthreads();
    b2_add_tile_sums<S>(sm.part[(rounds - 1) % 2], rounds - 1, tl, nsub, acc,
                        grp);
}

// B2's own sum (B2Tiles)
template <class S>
__device__ __forceinline__ void b2_rows_force(
        const float* qi, int ni, long long i0, const float* qj,
        const float* gmj, int nj, float eps2, typename S::Smem& sm,
        float (&acc)[S::OWN]) {
    b2_rows_force_tiled<S>(qi, ni, i0, qj, gmj, B2Tiles{nj}, eps2, sm,
                           acc);
}

}  // namespace nbody
