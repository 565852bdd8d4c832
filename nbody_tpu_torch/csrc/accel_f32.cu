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
// row. A block computes RB rows of one batch row: the block force of
// f32_force.cuh (b2_rows_force), shared with simulate's float32 step
// (sim_step_f32.cu), which has the design; its owner threads write the
// rows' components.
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

#include "f32_force.cuh"

namespace {

template <class S>
__global__ void __launch_bounds__(S::THREADS)
accel_f32_kernel(const float* __restrict__ qi, const float* __restrict__ qj,
                 const float* __restrict__ gmj, float* __restrict__ a,
                 int ni, int nj, float eps2) {
    __shared__ typename S::Smem sm;

    const size_t b = blockIdx.y;
    const long long i0 = static_cast<long long>(blockIdx.x) * S::RB;
    float acc[S::OWN];
    nbody::b2_rows_force<S>(qi + b * ni * 3, ni, i0, qj + b * nj * 3,
                            gmj + b * nj, nj, eps2, sm, acc);
    a += b * ni * 3;
#pragma unroll
    for (int k = 0; k < S::OWN; ++k) {
        const int o = threadIdx.x + k * S::THREADS;
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
    if (nbody::b2_large(B, ni))
        launch<nbody::B2Large>(qi, qj, gmj, a, B, ni, nj, eps2, s);
    else
        launch<nbody::B2Small>(qi, qj, gmj, a, B, ni, nj, eps2, s);
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

// What the card says of B2 in the shape it takes at B = 1, ni rows
// (forces.cuh kernel_info).
extern "C" int accel_f32_info(int ni, int* out) {
    using nbody::B2Large;
    using nbody::B2Small;
    if (ni <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return nbody::b2_large(1, ni)
               ? nbody::kernel_info(accel_f32_kernel<B2Large>,
                                    B2Large::THREADS, B2Large::RB, out)
               : nbody::kernel_info(accel_f32_kernel<B2Small>,
                                    B2Small::THREADS, B2Small::RB, out);
}
