// The graded step in float32: kernel B2's force, the Euler update and the
// graded drivers' checks, one launch per step (graded.cuh has the chunk
// loop and the checks).
//
// Replaces, on the graded path at precision 'f32', nbody_tpu/ops/
// pallas_forces.py::_accel_kernel together with the per-step work around it
// (the JAX package's float32 chunk scans, nbody_tpu/models/direct_sum.py,
// and on the mesh nbody_tpu/parallel/solver_sharded.py _p12_chunk_sharded
// and _p3_chunks_sharded around its ordered tile partials). Per step t and
// scenario row b:
//
//   gm_j = fl32(fl32(m0_j + fl32(mh_j * fst[t])) * fl32(G))
//   a_i  = B2's sum: 128-wide tile sums (accel_f32.cu), added to the row in
//          ascending tile order from 0; on the mesh the ordered sum at
//          tile T (f32_force.cuh GroupTiles), which is B2's at T = 128
//   v_i' = v_i + a_i*dt;  q_i' = q_i + v_i'*dt
//
// The tile width, the fold inside a tile and the order of the tile sums are
// B2's (its pair term is shared, forces.cuh), so the force is bitwise equal
// to kernel B2 (accel_f32.cu) at any n, and the step to B2 plus the PyTorch
// ops of the drivers' plain chunk; on the mesh, to the ordered ring
// (parallel/sharded.ring_accel_ordered) plus those ops.
//
// Layout: a block owns RB rows of one scenario row and walks the sources
// in rounds of TW tiles. In a round, all THREADS threads compute the pair
// terms of the block's rows into shared memory, a source per thread at a
// time; then one thread per (row, component, tile) folds that tile's terms
// from 0 in ascending j, B2's tile sum; then one thread per (row,
// component) adds the tile sums in ascending order to its register, B2's
// ((0 + P0) + P1) + ... (grouped: into the group's partial, which goes
// into the register at the group's end), and at the end applies the Euler
// update. At n = 1024, B = 1: 512 blocks of 256 threads, one round. A
// grouped round first writes its tiles' first sources, lengths and group
// ends into shared memory (one barrier more a round).
//
// The mesh, the row-range form (as graded_step_f64.cu's): a launch takes
// the rows [r0, r0 + ni) of a state kept in k blocks of ni rows
// (blocks.cuh), reads every row as a source and writes its rows into the
// same place of the other buffer; block (0, 0) checks the previous step
// on the whole state. Blocked = false where the sources lie in one block
// (one device, a mesh of one body rank), true (k > 1) walking them with a
// BlockCursor. At tile 128, or a tile of all n, the ordered sum is B2's
// own and the launch takes B2Tiles.
//
// Bound: at n = 1024 the launch and the chain of one tile sum (128
// dependent adds), not the fp32 issue of the n^2 pair terms (18 FP32
// instructions a pair unfused under the library's -fmad=false, 0.28 us at
// the card's peak).

#include <cuda_runtime.h>

#include "f32_force.cuh"
#include "graded.cuh"

namespace {

using nbody::GradedArgs;

constexpr int TJ = 128;              // B2's tile width
constexpr int RB = 2;                // rows per block
constexpr int TW = 8;                // tiles a round
constexpr int THREADS = 256;
constexpr int CHECK_THREADS = 256;
static_assert(3 * RB * TW <= THREADS, "one thread per tile sum");
static_assert(nbody::B2_TJ == TJ, "B2's tile");

// Tiles: nbody::B2Tiles (one device) or nbody::GroupTiles (the mesh, at
// a.tile); Blocked: whether the state may lie in several blocks
template <bool Blocked, class Tiles>
__global__ void __launch_bounds__(THREADS)
graded_step_f32_kernel(GradedArgs<float> a, const float* __restrict__ q_in,
                       const float* __restrict__ v_in,
                       float* __restrict__ q_out, float* __restrict__ v_out,
                       int off, int check) {
    __shared__ float s_term[3][RB][TW][TJ + 1];  // +1: no bank conflicts
    __shared__ float s_part[3][RB][TW];
    __shared__ float s_qi[3][RB];
    // a grouped round's tiles: first source, length, whether it ends its
    // group (two rounds' worth, so a round's table is written while the
    // last round's sums are still being added)
    __shared__ int s_first[2][TW], s_len[2][TW];
    __shared__ bool s_ends[2][TW];

    const int t = nbody::graded_step_at(a, off);
    const int b = blockIdx.y, i0 = a.r0 + blockIdx.x * RB, tid = threadIdx.x;
    const int n = a.n, live = min(RB, nbody::graded_end(a) - i0);
    if (check && blockIdx.x == 0 && b == 0)
        nbody::graded_check(a, const_cast<float*>(q_in),
                            const_cast<float*>(v_in), t - 1, false);
    if (live <= 0) return;  // a rank without rows: the checks only
    if (nbody::graded_frozen(a, b, t)) {
        nbody::copy_bodies(a, q_in, v_in, q_out, v_out, b, i0, RB);
        return;
    }
    // scenario row src's sources from qb; the block's rows from qb + own,
    // written to the same place of scenario row b
    const int src = nbody::graded_source_row(a, b, t, check);
    const long long sb = 3LL * src * a.L.ni, own = a.L.at(0, i0);
    const long long ob = 3LL * b * a.L.ni + own;
    const float* qb = q_in + sb;
    const size_t mb = static_cast<size_t>(b) * n;
    const float f = a.fst[t];
    const Tiles tl = Tiles::of(n, a.tile);
    if (tid < 3 * RB) {
        const int r = tid / 3, c = tid % 3;
        s_qi[c][r] = r < live ? qb[own + 3 * r + c] : 0.0f;
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
    float acc = 0.0f, grp = 0.0f;
    const int nsub = tl.count();
    for (int s0 = 0, rd = 0; s0 < nsub; s0 += TW, ++rd) {
        const int tiles = min(TW, nsub - s0), h = rd & 1;
        if constexpr (Tiles::grouped) {
            if (tid < tiles) {
                s_first[h][tid] = tl.start(s0 + tid);
                s_len[h][tid] = tl.len(s0 + tid);
                s_ends[h][tid] = tl.ends_group(s0 + tid);
            }
            __syncthreads();
        }
        // every pair term of the round's tiles, a source at a time
        const int j0 = tl.start(s0);
        const int span = Tiles::grouped ? tiles * TJ : min(TW * TJ, n - j0);
        nbody::BlockCursor cur(a.L, j0);
        for (int jj = tid; jj < span; jj += THREADS) {
            const int w = jj / TJ, col = jj % TJ;
            if (Tiles::grouped && col >= s_len[h][w]) continue;
            const int j = (Tiles::grouped ? s_first[h][w] : j0 + w * TJ)
                          + col;
            const float* p = qb + nbody::source_at<Blocked>(cur, a.L, j);
            const float4 s = make_float4(
                p[0], p[1], p[2],
                nbody::graded_gm(a.m0[mb + j], a.mh[mb + j], f, a.G));
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
            if (w < tiles) {
                const float* term = s_term[c][r][w];
                const int cols = Tiles::grouped ? s_len[h][w]
                                                : min(TJ, n - j0 - w * TJ);
                float p = 0.0f;
#pragma unroll 8
                for (int jj = 0; jj < cols; ++jj) p += term[jj];
                s_part[c][r][w] = p;
            }
        }
        __syncthreads();
        // the tile sums, added to the row in ascending tile order (grouped:
        // to the group's partial, added to the row at the group's end)
        if (tid < 3 * RB)
            for (int w = 0; w < tiles; ++w) {
                if constexpr (Tiles::grouped) {
                    grp += s_part[fc][fr][w];
                    if (s_ends[h][w]) {
                        acc += grp;
                        grp = 0.0f;
                    }
                } else {
                    acc += s_part[fc][fr][w];
                }
            }
    }
    if (tid < 3 * RB && fr < live) {
        const long long x = own + 3 * fr + fc;
        nbody::graded_euler(acc, qb[x], v_in[sb + x], a.dt,
                            q_out[ob + 3 * fr + fc], v_out[ob + 3 * fr + fc]);
    }
}

__global__ void __launch_bounds__(CHECK_THREADS)
graded_check_f32_kernel(GradedArgs<float> a, float* q, float* v, int off) {
    nbody::graded_check(a, q, v, nbody::graded_step_at(a, off), true);
}

}  // namespace

// Steps s0 + 1 .. s0 + K of a graded driver in float32; the arguments are
// graded_chunk_f64_launch's (graded_step_f64.cu), eps2 = fl32(eps^2) and
// G, dt rounded to float32.
extern "C" int graded_chunk_f32_launch(
        float* q, float* v, float* q2, float* v2, const float* m0,
        const float* mh, const float* fst, const float* md2,
        const long long* others, long long* arr, long long* arr2,
        long long* hit, unsigned char* flag, float* min_d2, float* q_snap,
        float* v_snap, int mode, int B, int n, int D, int planet, float G,
        float dt, float eps2, float r2, const int* s0, int K, int* launched,
        void* stream) {
    if (!nbody::graded_args_ok(mode, B, n, D, s0, K) || launched == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    *launched = 0;
    const GradedArgs<float> a = nbody::graded_args(
        m0, mh, fst, md2, others, arr, arr2, hit, flag, min_d2, q_snap,
        v_snap, mode, B, n, D, planet, G, dt, eps2, r2, s0);
    const dim3 grid((n + RB - 1) / RB, B);
    return nbody::graded_chunk(
        graded_step_f32_kernel<false, nbody::B2Tiles>,
        graded_check_f32_kernel, grid, THREADS, CHECK_THREADS, a, q, v, q2,
        v2, K, static_cast<cudaStream_t>(stream), launched);
}

// One launch of a mesh rank (graded.cuh graded_rows_launch), as
// graded_rows_f64_step (graded_step_f64.cu) has it, in float32 with the
// force's ordered sum at tile T >= 1 (f32_force.cuh GroupTiles; a tile
// above n is one group of n): bitwise the ordered ring's
// (parallel/sharded.ring_accel_ordered) at that tile, and at T = 128 the
// one-device kernel's.
extern "C" int graded_rows_f32_step(
        const float* m0, const float* mh, const float* fst, const float* md2,
        const long long* others, long long* arr, long long* arr2,
        long long* hit, unsigned char* flag, float* min_d2, float* q_snap,
        float* v_snap, int mode, int B, int n, int D, int planet, int p1,
        int p2, int ni, int k, int tile, float G, float dt, float eps2,
        float r2, float* qv, float* qv_out, int r0, const int* s0, int off,
        int check, void* stream) {
    GradedArgs<float> a = nbody::graded_args(
        m0, mh, fst, md2, others, arr, arr2, hit, flag, min_d2, q_snap,
        v_snap, mode, B, n, D, planet, G, dt, eps2, r2, s0);
    if (tile < 1
        || !nbody::graded_rows_args(a, p1, p2, ni, k, r0, off,
                                    qv_out != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    a.tile = tile < n ? tile : n;
    const long long half = a.L.stride / 2;   // a block's q rows, then v's
    // B2's own sum at tile 128 or a tile of all n (f32_force.cuh)
    const bool own = a.tile == nbody::B2_TJ || a.tile == n;
    using StepKernel = void (*)(GradedArgs<float>, const float*,
                                const float*, float*, float*, int, int);
    const StepKernel step =
        k > 1 ? (own ? &graded_step_f32_kernel<true, nbody::B2Tiles>
                     : &graded_step_f32_kernel<true, nbody::GroupTiles>)
              : (own ? &graded_step_f32_kernel<false, nbody::B2Tiles>
                     : &graded_step_f32_kernel<false, nbody::GroupTiles>);
    return nbody::graded_rows_launch(
        step,
        graded_check_f32_kernel, RB, THREADS, CHECK_THREADS, a, qv,
        qv + half, qv_out, qv_out ? qv_out + half : nullptr, off, check,
        static_cast<cudaStream_t>(stream));
}
