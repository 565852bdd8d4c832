// Kernel B4: all-pairs softened gravitational acceleration in double-double
// binary64 (about 106 bits), folded over ascending j for every row.
//
// Replaces nbody_tpu/ops/forces.py::pairwise_accel_tf3 (:54-190), the JAX
// package's force beyond binary64 for precisions 'tf3', 'ddp' and 'dd+'
// of simulate(). That one is triple-float32 XLA code: a TPU has no
// binary64, so it carries three float32 words and gauges every wide-range
// intermediate by a dynamic power of two to stay clear of float32's range
// and flushed subnormals. The H100 has binary64, so a pair of doubles goes
// beyond it (2^-104 an operation against about 2^-70) with binary64's
// range: no gauge and no rescale. The physics is the same:
//
//   dx = q_j - q_i  (likewise dy, dz; every quantity double-double)
//   d2 = ((dx*dx + dy*dy) + dz*dz) + eps^2      (eps^2 = two_prod(eps, eps))
//   a_i = fold over ascending j of (gm_j / (d2 * sqrt(d2))) * dx
//
// with gm = G * m_eff formed by the caller. Every operation is the
// sequence of its twin in ops/ddfloat.py (dd.cuh), so the kernel is bitwise
// equal to its plain version `accel_dd_ref`.
//
// Layout: q (B, n, 3) and gm (B, n) double-double, a (B, n, 3), each value
// two contiguous doubles (hi, lo). The grid is (ceil(n / DD_R), B): a block
// owns DD_R rows of one scenario row; dd_force.cuh has the block's work,
// its design and its bound (the fp64 pipe, about 330 instructions a pair).

#include <cuda_runtime.h>

#include "dd_force.cuh"

namespace {

using nbody::dd;

__global__ void __launch_bounds__(nbody::DD_THREADS)
accel_dd_kernel(const dd* __restrict__ q, const dd* __restrict__ gm,
                dd* __restrict__ a, int n, dd eps2) {
    __shared__ nbody::DdRowsSmem sm;
    const int b = blockIdx.y;
    const dd* qb = q + static_cast<size_t>(b) * n * 3;
    const dd* gb = gm + static_cast<size_t>(b) * n;
    dd acc;
    size_t x;
    if (nbody::dd_rows_accel(qb, n, blockIdx.x * nbody::DD_R, eps2,
                             [gb](int j) { return gb[j]; }, sm, acc, x))
        a[static_cast<size_t>(b) * n * 3 + x] = acc;
}

}  // namespace

// a (B, n, 3) from q (B, n, 3) and gm (B, n), all double-double as pairs
// of doubles; eps2 = eps2_hi + eps2_lo. Returns the launch error, or
// cudaErrorInvalidValue without launching.
extern "C" int accel_dd_launch(const double* q, const double* gm, double* a,
                               int B, int n, double eps2_hi, double eps2_lo,
                               void* stream) {
    if (B <= 0 || B > 65535 || n <= 0)  // B rides gridDim.y
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + nbody::DD_R - 1) / nbody::DD_R, B);
    accel_dd_kernel<<<grid, nbody::DD_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const dd*>(q), reinterpret_cast<const dd*>(gm),
        reinterpret_cast<dd*>(a), n, dd{eps2_hi, eps2_lo});
    return static_cast<int>(cudaGetLastError());
}
