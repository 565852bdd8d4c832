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
// As in the TPU kernel, each j-tile is summed on its own and the tile sums
// are added to the row's accumulator in ascending tile order. Besides
// mirroring the reference, the two-level sum keeps the rounding error of a
// row near sqrt(TJ) + sqrt(nj/TJ) half-ulps of its acceleration instead of
// the sqrt(nj) of one flat fold (34 against 256 at nj = 65536). rsqrtf is
// the hardware's approximate reciprocal square root (MUFU.RSQ, within 2 ulp),
// as lax.rsqrt is on the TPU. The j == i term is 0 * w and adds nothing;
// eps2 > 0 keeps its w finite.
//
// Layout: qi (B, ni, 3), qj (B, nj, 3), gmj (B, nj) = fl(G * m_eff) and
// a (B, ni, 3), all contiguous float32. The batch row b rides blockIdx.y:
// rows of different b never mix, and each row's fold order does not depend
// on B, so a batched launch is bitwise equal to B launches of one row. A
// thread owns one row i and keeps its sums in registers; a block owns
// THREADS rows of one batch row. For each tile of TJ sources, in
// ascending order, the block stages (x, y, z, gm) as one float4 per source
// in shared memory (one source per thread), and every thread folds the tile
// in ascending j. The last tile is folded only to its end, so any ni and nj
// work unpadded. The TPU's sequential j grid axis, which carried the sum
// from one grid step to the next, becomes this loop inside the block.
// There are no atomics: the result is bitwise the same from run to run.
//
// Bound: fp32 issue. A pair costs 18 FP32 instructions and one MUFU rsqrt;
// a tile of TJ sources is 2 KB of shared memory, read TJ times from it, and
// all of qj is read once per block, from L2 after the first blocks. The
// library is built with -fmad=false for kernel B1's bit equality, so the
// five multiply-adds of a pair (two in d2, one in each row sum) stay
// separate FMUL + FADD instead of FFMA: 18 instructions where 13 would do.
// Each block is one wave of THREADS rows, so n = 1024 fills only 8 SMs; the
// graded solve runs its own step kernel (graded_step_f32.cu), which splits
// j across threads with the same sums. FFMA and a wider unroll are later
// work. The pair term and the tile sum live in forces.cuh.

#include <cuda_runtime.h>

#include "forces.cuh"

namespace {

constexpr int THREADS = 128;  // rows i per block, one per thread
constexpr int TJ = THREADS;   // sources j per tile, one staged per thread

__global__ void __launch_bounds__(THREADS)
accel_f32_kernel(const float* __restrict__ qi, const float* __restrict__ qj,
                 const float* __restrict__ gmj, float* __restrict__ a,
                 int ni, int nj, float eps2) {
    __shared__ float4 s_src[TJ];

    const size_t b = blockIdx.y;
    qi += b * ni * 3;
    qj += b * nj * 3;
    gmj += b * nj;
    a += b * ni * 3;
    const int t = threadIdx.x;
    const int i = blockIdx.x * THREADS + t;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f;
    if (i < ni) {
        const size_t o = static_cast<size_t>(i) * 3;
        xi = qi[o];
        yi = qi[o + 1];
        zi = qi[o + 2];
    }
    float ax = 0.0f, ay = 0.0f, az = 0.0f;

    for (int j0 = 0; j0 < nj; j0 += TJ) {
        const int cols = min(TJ, nj - j0);
        __syncthreads();  // every thread has folded the previous tile
        if (t < cols) {
            const size_t o = static_cast<size_t>(j0 + t) * 3;
            s_src[t] = make_float4(qj[o], qj[o + 1], qj[o + 2], gmj[j0 + t]);
        }
        __syncthreads();

        float px, py, pz;
        nbody::b2_tile_sum(s_src, cols, xi, yi, zi, eps2, px, py, pz);
        ax += px;
        ay += py;
        az += pz;
    }
    if (i < ni) {
        const size_t o = static_cast<size_t>(i) * 3;
        a[o] = ax;
        a[o + 1] = ay;
        a[o + 2] = az;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// without launching. ni rides gridDim.x: ceil(ni / THREADS) blocks, at most
// 2^24 for an int ni, well inside the 2^31 - 1 limit. B rides gridDim.y,
// whose limit is 65535. nj rides the loop inside each block and has no grid
// limit. B, ni and nj must be at least 1.
extern "C" int accel_f32_launch(const float* qi, const float* qj,
                                const float* gmj, float* a, int B, int ni,
                                int nj, float eps2, void* stream) {
    if (B <= 0 || B > 65535 || ni <= 0 || nj <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 blocks(static_cast<unsigned>(ni / THREADS)
                      + (ni % THREADS != 0 ? 1u : 0u),
                      static_cast<unsigned>(B));
    accel_f32_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        qi, qj, gmj, a, ni, nj, eps2);
    return static_cast<int>(cudaGetLastError());
}
