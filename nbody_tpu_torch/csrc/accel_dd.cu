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
// Layout: rows qi (B, ni, 3) against sources qj (B, nj, 3) with gm (B, nj),
// double-double, a (B, ni, 3), each value two contiguous doubles (hi, lo);
// the self form is qi = qj. The grid is (ceil(ni / 4), B): a block owns
// the 4 rows of one scenario row of the geometry DdNarrow; dd_force.cuh
// has the block's work, its design and its bound (the fp64 pipe, 333
// instructions a pair). A row's fold reads only its own position and the
// sources, so the row blocks of a mesh, each launched on its own, give the
// self form's bits.

#include <cuda_runtime.h>

#include "dd_force.cuh"

namespace {

using nbody::dd;
using Geo = nbody::DdNarrow;

__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
accel_dd_kernel(const dd* __restrict__ qi, const dd* __restrict__ qj,
                const dd* __restrict__ gm, dd* __restrict__ a, int ni, int nj,
                dd eps2) {
    __shared__ Geo::Smem sm;
    const int b = blockIdx.y, i0 = blockIdx.x * Geo::R;
    const size_t rows = static_cast<size_t>(b) * ni;
    const size_t srcs = static_cast<size_t>(b) * nj;
    nbody::dd_rows_qi<Geo>(qi + rows * 3, ni, i0, sm);
    if (threadIdx.x < Geo::NC) {
        nbody::dd_rows_terms<Geo>(qj + srcs * 3, nj, eps2,
                                  nbody::DdGmTable{gm + srcs}, sm);
        return;
    }
    size_t x;
    const bool folds = nbody::dd_fold_lane<Geo>(i0, ni, x);
    const dd acc = nbody::dd_rows_fold<Geo>(nj, folds, sm);
    if (folds) a[rows * 3 + x] = acc;
}

}  // namespace

// a (B, ni, 3) of rows qi (B, ni, 3) from sources qj (B, nj, 3) under gm
// (B, nj), all double-double as pairs of doubles; eps2 = eps2_hi +
// eps2_lo. Returns the launch error, or cudaErrorInvalidValue without
// launching.
extern "C" int accel_dd_launch(const double* qi, const double* qj,
                               const double* gm, double* a, int B, int ni,
                               int nj, double eps2_hi, double eps2_lo,
                               void* stream) {
    if (B <= 0 || B > 65535 || ni <= 0 || nj <= 0)  // B rides gridDim.y
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((ni + Geo::R - 1) / Geo::R, B);
    accel_dd_kernel<<<grid, Geo::THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const dd*>(qi), reinterpret_cast<const dd*>(qj),
        reinterpret_cast<const dd*>(gm), reinterpret_cast<dd*>(a), ni, nj,
        dd{eps2_hi, eps2_lo});
    return static_cast<int>(cudaGetLastError());
}
