// Kernel B2: all-pairs softened gravitational acceleration in float32, the
// rsqrt form of the throughput path, for rows qi against sources qj, in
// every row of a scenario batch.
//
// Replaces nbody_tpu/ops/pallas_forces.py::_accel_kernel (its wrappers
// pallas_accel, pallas_accel_cross and pallas_step). Per pair:
//
//   dx = qj_j - qi_i                     (likewise dy, dz)
//   d2 = ((dx*dx + dy*dy) + dz*dz) + eps2
//   inv = rsqrt(d2);  w = gm_j * ((inv*inv)*inv)
//   a_i = sum over j-tiles, ascending, of (fold over the tile's j of w*dx)
//
// As in the TPU kernel, each 128-wide j-tile is summed on its own and the
// tile sums are added to the row's accumulator in ascending tile order.
// Besides mirroring the reference, the two-level sum keeps the rounding
// error of a row near sqrt(TJ) + sqrt(nj/TJ) half-ulps of its acceleration
// instead of the sqrt(nj) of one flat fold (34 against 256 at nj = 65536).
// The pair term is forces.cuh's, shared with the fp32 graded step kernel
// (graded_step_f32.cu), whose force must stay bitwise equal to this one:
// each term t = w*dx is rounded on its own, each tile is folded from 0 in
// ascending j, and the tile sums are added from 0 in ascending order. The
// j == i term is 0 * w and adds nothing; eps2 > 0 keeps its w finite.
//
// Layout: qi (B, ni, 3), qj (B, nj, 3), gmj (B, nj) = fl(G * m_eff) and
// a (B, ni, 3), all contiguous float32. The batch row b rides blockIdx.y:
// rows of different b never mix, and no sum depends on B or on the shape
// chosen below, so a batched launch is bitwise equal to B launches of one
// row. A block owns RB = R * LR rows of one batch row and walks the
// sources in rounds of TPR tiles. A thread owns R rows and, in a round, one
// tile: it folds that tile's pair terms for its R rows (one staged source
// feeds R terms). The LR lanes of a warp that share a tile read the same
// staged source (a broadcast); a warp folds 32 / LR tiles at once, and the
// W warps of the block fold the rest of the round's tiles. The tile sums go
// through shared memory, and one owner thread per (row, component) adds
// them to its register in ascending tile order. The next round's sources
// are copied into the other half of a 2-deep shared ring with cp.async
// while the current round is folded; one barrier a round. The last tile is
// folded only to its end, so any ni and nj work unpadded. There are no
// atomics: the result is bitwise the same from run to run.
//
// Bound: fp32 issue. A pair costs 18 FP32 instructions and one MUFU rsqrt
// (rsqrt_approx, forces.cuh: no denormal scaling, which d2 >= eps2 never
// needs). The library is built with -fmad=false, and the bits shared with
// the fp32 graded step keep the five multiply-adds of a pair (two in d2,
// three in the sums) as FMUL + FADD: 18 instructions where 13 would do. The
// design takes away what is not pair arithmetic: R rows a thread cut the
// shared loads and the loop overhead per pair by R, and two shapes keep the
// card full. LARGE (R = 4, LR = 32, W = 4: 128 rows a block) serves ni in
// the tens of thousands, where every block rereads all of qj from L2;
// SMALL (R = 2, LR = 8, W = 2: 16 rows a block, 8 tiles a round) splits
// ni = 1024 into 64 blocks a batch row, so B = 2 fills 128 SMs, each
// thread folding one 128-term tile for its 2 rows.

#include <cuda_runtime.h>

#include "forces.cuh"

namespace {

constexpr int TJ = 128;          // sources a tile: the TPU kernel's sums
constexpr int STRIDE = TJ + 2;   // float4s between staged tiles: the LR
                                 // lanes of each tile land on other banks
// the large shape is taken when its grid has at least this many blocks
// (two waves of 132 SMs); below it, the small one
constexpr int LARGE_MIN_BLOCKS = 264;

template <int R_, int LR_, int W_>
struct Shape {
    static constexpr int R = R_;            // rows a thread
    static constexpr int LR = LR_;          // lanes of a warp on one tile
    static constexpr int THREADS = 32 * W_;
    static constexpr int LT = 32 / LR;      // tiles a warp folds in a round
    static constexpr int RB = R * LR;       // rows a block
    static constexpr int TPR = W_ * LT;     // tiles a round
    static constexpr int SPAN = TPR * TJ;   // sources a round
    static constexpr int OWN = (3 * RB + THREADS - 1) / THREADS;
    static_assert(32 % LR == 0, "a warp holds whole row groups");
};

using Large = Shape<4, 32, 4>;
using Small = Shape<2, 8, 2>;

// Copy the sources [j0, j0 + cnt) of a round into the staged layout: tile
// k of the round at buf[k * STRIDE], one float4 (x, y, z, gm) a source.
template <class S>
__device__ __forceinline__ void stage(float4* buf, const float* qj,
                                      const float* gmj, int j0, int cnt) {
    for (int k = threadIdx.x; k < cnt; k += S::THREADS) {
        float* d = reinterpret_cast<float*>(buf + (k / TJ) * STRIDE + k % TJ);
        const size_t j = static_cast<size_t>(j0) + k;
        nbody::cp_async4(d, qj + j * 3);
        nbody::cp_async4(d + 1, qj + j * 3 + 1);
        nbody::cp_async4(d + 2, qj + j * 3 + 2);
        nbody::cp_async4(d + 3, gmj + j);
    }
}

// The owners' share of a round: each (row, component) adds the round's
// tile sums, in ascending tile order, to its register.
template <class S>
__device__ __forceinline__ void add_tile_sums(
        float (*part)[3][S::RB], int round, int nj,
        float (&acc)[S::OWN]) {
#pragma unroll
    for (int k = 0; k < S::OWN; ++k) {
        const int o = threadIdx.x + k * S::THREADS;
        if (o < 3 * S::RB)
            for (int tt = 0; tt < S::TPR
                 && (round * S::TPR + tt) * TJ < nj; ++tt)
                acc[k] += part[tt][o / S::RB][o % S::RB];
    }
}

template <class S>
__global__ void __launch_bounds__(S::THREADS)
accel_f32_kernel(const float* __restrict__ qi, const float* __restrict__ qj,
                 const float* __restrict__ gmj, float* __restrict__ a,
                 int ni, int nj, float eps2) {
    __shared__ float4 s_src[2][S::TPR * STRIDE];
    __shared__ float s_part[2][S::TPR][3][S::RB];

    const size_t b = blockIdx.y;
    qi += b * ni * 3;
    qj += b * nj * 3;
    gmj += b * nj;
    a += b * ni * 3;
    const int tid = threadIdx.x, lane = tid % 32;
    const int lr = lane % S::LR;
    const int tt = (tid / 32) * S::LT + lane / S::LR;   // tile of the round
    const long long i0 = static_cast<long long>(blockIdx.x) * S::RB;

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
    float acc[S::OWN];
#pragma unroll
    for (int k = 0; k < S::OWN; ++k) acc[k] = 0.0f;

    const int rounds = (nj - 1) / S::SPAN + 1;
    stage<S>(s_src[0], qj, gmj, 0, min(S::SPAN, nj));
    nbody::cp_async_commit();
    for (int rd = 0; rd < rounds; ++rd) {
        nbody::cp_async_wait<0>();
        // this round's sources are in; every thread has folded the last
        // round (its half of the ring is free) and written its tile sums
        __syncthreads();
        if (rd + 1 < rounds) {
            const int j1 = (rd + 1) * S::SPAN;
            stage<S>(s_src[(rd + 1) % 2], qj, gmj, j1, min(S::SPAN, nj - j1));
        }
        nbody::cp_async_commit();
        if (rd > 0)
            add_tile_sums<S>(s_part[(rd - 1) % 2], rd - 1, nj, acc);

        const int j0 = (rd * S::TPR + tt) * TJ;
        if (j0 < nj) {
            const int cols = min(TJ, nj - j0);
            const float4* src = s_src[rd % 2] + tt * STRIDE;
            float px[S::R], py[S::R], pz[S::R];
#pragma unroll
            for (int r = 0; r < S::R; ++r) px[r] = py[r] = pz[r] = 0.0f;
#pragma unroll 4
            for (int jj = 0; jj < cols; ++jj) {
                const float4 s = src[jj];
#pragma unroll
                for (int r = 0; r < S::R; ++r) {
                    float tx, ty, tz;
                    nbody::b2_pair_term(s, xi[r], yi[r], zi[r], eps2, tx, ty,
                                        tz);
                    px[r] += tx;
                    py[r] += ty;
                    pz[r] += tz;
                }
            }
            float (*part)[S::RB] = s_part[rd % 2][tt];
#pragma unroll
            for (int r = 0; r < S::R; ++r) {
                part[0][r * S::LR + lr] = px[r];
                part[1][r * S::LR + lr] = py[r];
                part[2][r * S::LR + lr] = pz[r];
            }
        }
    }
    __syncthreads();
    add_tile_sums<S>(s_part[(rounds - 1) % 2], rounds - 1, nj, acc);
#pragma unroll
    for (int k = 0; k < S::OWN; ++k) {
        const int o = tid + k * S::THREADS;
        const long long i = i0 + o % S::RB;
        if (o < 3 * S::RB && i < ni)
            a[i * 3 + o / S::RB] = acc[k];
    }
}

template <class S>
void launch(const float* qi, const float* qj, const float* gmj, float* a,
            int B, int ni, int nj, float eps2, cudaStream_t stream) {
    const dim3 blocks(static_cast<unsigned>((ni + (S::RB - 1LL)) / S::RB),
                      static_cast<unsigned>(B));
    accel_f32_kernel<S><<<blocks, S::THREADS, 0, stream>>>(qi, qj, gmj, a,
                                                           ni, nj, eps2);
}

// rsqrtf and rsqrt_approx side by side, one value a thread.
__global__ void rsqrt_probe_kernel(const float* __restrict__ x,
                                   float* __restrict__ want,
                                   float* __restrict__ got, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) {
        want[i] = rsqrtf(x[i]);
        got[i] = nbody::rsqrt_approx(x[i]);
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// without launching. ni rides gridDim.x: ceil(ni / RB) blocks, at most 2^27
// for an int ni, well inside the 2^31 - 1 limit. B rides gridDim.y, whose
// limit is 65535. nj rides the rounds inside each block and has no grid
// limit. B, ni and nj must be at least 1. The shape is chosen from B and ni
// alone; both shapes give the same bits.
extern "C" int accel_f32_launch(const float* qi, const float* qj,
                                const float* gmj, float* a, int B, int ni,
                                int nj, float eps2, void* stream) {
    if (B <= 0 || B > 65535 || ni <= 0 || nj <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if ((ni + (Large::RB - 1LL)) / Large::RB * B >= LARGE_MIN_BLOCKS)
        launch<Large>(qi, qj, gmj, a, B, ni, nj, eps2, s);
    else
        launch<Small>(qi, qj, gmj, a, B, ni, nj, eps2, s);
    return static_cast<int>(cudaGetLastError());
}

// want[i] = rsqrtf(x[i]) and got[i] = rsqrt.approx.ftz(x[i]) for i < n, so
// a caller can check that B2's and B3's rsqrt gives rsqrtf's bits on d2.
extern "C" int rsqrt_probe_launch(const float* x, float* want, float* got,
                                  int n, void* stream) {
    if (n <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    rsqrt_probe_kernel<<<(n + 255) / 256, 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, want, got, n);
    return static_cast<int>(cudaGetLastError());
}
