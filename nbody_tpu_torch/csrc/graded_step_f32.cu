// The graded step in float32: kernel B2's force, the Euler update and the
// graded drivers' checks, one launch per step (graded.cuh has the chunk
// loop and the checks).
//
// Replaces, on the graded path at precision 'f32', nbody_tpu/ops/
// pallas_forces.py::_accel_kernel together with the per-step work around it
// (the JAX package's float32 chunk scans, nbody_tpu/models/direct_sum.py).
// Per step t and scenario row b:
//
//   gm_j = fl32(fl32(m0_j + fl32(mh_j * fst[t])) * fl32(G))
//   a_i  = B2's sum: 128-wide tile sums (accel_f32.cu), added to the row in
//          ascending tile order from 0
//   v_i' = v_i + a_i*dt;  q_i' = q_i + v_i'*dt
//
// The tile width, the fold inside a tile and the order of the tile sums are
// B2's (its pair term is shared, forces.cuh), so the force is bitwise equal
// to kernel B2 (accel_f32.cu) at any n, and the step to B2 plus the PyTorch
// ops of the drivers' plain chunk.
//
// Layout: one device only (graded.cuh's one block of n rows; the f32 mesh
// shards bodies around the ordered ring instead). A block owns RB rows and
// walks the sources in
// rounds of TW tiles. In a round, all THREADS threads compute the pair
// terms of the block's rows into shared memory, a source per thread at a
// time; then one thread per (row, component, tile) folds that tile's 128
// terms from 0 in ascending j, B2's tile sum; then one thread per (row,
// component) adds the tile sums in ascending order to its register, B2's
// ((0 + P0) + P1) + ..., and at the end applies the Euler update. At
// n = 1024, B = 1: 512 blocks of 256 threads, one round.
//
// Bound: at n = 1024 the launch and the chain of one tile sum (128
// dependent adds), not the fp32 issue of the n^2 pair terms (18 FP32
// instructions a pair unfused under the library's -fmad=false, 0.28 us at
// the card's peak).

#include <cuda_runtime.h>

#include "forces.cuh"
#include "graded.cuh"

namespace {

using nbody::GradedArgs;

constexpr int TJ = 128;              // B2's tile width
constexpr int RB = 2;                // rows per block
constexpr int TW = 8;                // tiles a round
constexpr int THREADS = 256;
constexpr int CHECK_THREADS = 256;
static_assert(3 * RB * TW <= THREADS, "one thread per tile sum");


__global__ void __launch_bounds__(THREADS)
graded_step_f32_kernel(GradedArgs<float> a, const float* __restrict__ q_in,
                       const float* __restrict__ v_in,
                       float* __restrict__ q_out, float* __restrict__ v_out,
                       int t, int check) {
    __shared__ float s_term[3][RB][TW][TJ + 1];  // +1: no bank conflicts
    __shared__ float s_part[3][RB][TW];
    __shared__ float s_qi[3][RB];

    const int b = blockIdx.y, i0 = blockIdx.x * RB, tid = threadIdx.x;
    const int n = a.n;
    const size_t row = static_cast<size_t>(n) * 3;
    if (check && blockIdx.x == 0 && b == 0)
        nbody::graded_check(a, const_cast<float*>(q_in),
                            const_cast<float*>(v_in), t - 1, false);

    float* qo = q_out + b * row;
    float* vo = v_out + b * row;
    if (nbody::graded_frozen(a, b, t)) {
        nbody::copy_bodies(a, q_in, v_in, q_out, v_out, b, i0, RB);
        return;
    }
    const int src = nbody::graded_source_row(a, b, t, check);
    const float* qb = q_in + src * row;
    const float* vb = v_in + src * row;
    const size_t mb = static_cast<size_t>(b) * n;
    const float f = a.fst[t];
    if (tid < 3 * RB) {
        const int r = tid / 3, c = tid % 3;
        s_qi[c][r] = i0 + r < n ? qb[static_cast<size_t>(i0 + r) * 3 + c]
                                : 0.0f;
    }
    __syncthreads();
    float xi[RB], yi[RB], zi[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
        xi[r] = s_qi[0][r];
        yi[r] = s_qi[1][r];
        zi[r] = s_qi[2][r];
    }

    // thread (fr, fc), tid < 3 * RB, owns component fc of row fr
    const int fr = tid / 3, fc = tid % 3;
    float acc = 0.0f;
    for (int j0 = 0; j0 < n; j0 += TW * TJ) {
        const int span = min(TW * TJ, n - j0);
        // every pair term of the round's TW tiles, a source at a time
        for (int jj = tid; jj < span; jj += THREADS) {
            const size_t j = static_cast<size_t>(j0 + jj);
            const float4 s = make_float4(
                qb[j * 3], qb[j * 3 + 1], qb[j * 3 + 2],
                nbody::graded_gm(a.m0[mb + j], a.mh[mb + j], f, a.G));
            const int w = jj / TJ, col = jj % TJ;
#pragma unroll
            for (int r = 0; r < RB; ++r)
                nbody::b2_pair_term(s, xi[r], yi[r], zi[r], a.eps2,
                                    s_term[0][r][w][col],
                                    s_term[1][r][w][col],
                                    s_term[2][r][w][col]);
        }
        __syncthreads();
        // each tile's sum, folded from 0 in ascending j
        if (tid < 3 * RB * TW) {
            const int c = tid % 3, r = (tid / 3) % RB, w = tid / (3 * RB);
            if (w * TJ < span) {
                const float* term = s_term[c][r][w];
                const int cols = min(TJ, span - w * TJ);
                float p = 0.0f;
#pragma unroll 8
                for (int jj = 0; jj < cols; ++jj) p += term[jj];
                s_part[c][r][w] = p;
            }
        }
        __syncthreads();
        // the tile sums, added to the row in ascending tile order
        if (tid < 3 * RB)
            for (int w = 0; w < TW && w * TJ < span; ++w)
                acc += s_part[fc][fr][w];
    }
    if (tid < 3 * RB && i0 + fr < n) {
        const size_t x = static_cast<size_t>(i0 + fr) * 3 + fc;
        nbody::graded_euler(acc, qb[x], vb[x], a.dt, qo[x], vo[x]);
    }
}

__global__ void __launch_bounds__(CHECK_THREADS)
graded_check_f32_kernel(GradedArgs<float> a, float* q, float* v, int p) {
    nbody::graded_check(a, q, v, p, true);
}

}  // namespace

// Steps s0 + 1 .. s1 of a graded driver in float32; the arguments are
// graded_chunk_f64_launch's (graded_step_f64.cu), eps2 = fl32(eps^2) and
// G, dt rounded to float32.
extern "C" int graded_chunk_f32_launch(
        float* q, float* v, float* q2, float* v2, const float* m0,
        const float* mh, const float* fst, const float* md2,
        const long long* others, long long* arr, long long* arr2,
        long long* hit, unsigned char* flag, float* min_d2, float* q_snap,
        float* v_snap, int mode, int B, int n, int D, int planet, float G,
        float dt, float eps2, float r2, int s0, int s1, void* stream) {
    if (!nbody::graded_args_ok(mode, B, n, D, s0, s1))
        return static_cast<int>(cudaErrorInvalidValue);
    const GradedArgs<float> a = nbody::graded_args(
        m0, mh, fst, md2, others, arr, arr2, hit, flag, min_d2, q_snap,
        v_snap, mode, B, n, D, planet, G, dt, eps2, r2);
    const dim3 grid((n + RB - 1) / RB, B);
    return nbody::graded_chunk(
        graded_step_f32_kernel, graded_check_f32_kernel, grid, THREADS,
        CHECK_THREADS, a, q, v, q2, v2, s0, s1,
        static_cast<cudaStream_t>(stream));
}
