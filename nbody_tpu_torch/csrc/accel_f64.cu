// Kernel B1: all-pairs softened gravitational acceleration in IEEE binary64,
// with the serial spec's ascending-j fold for every row.
//
// Replaces nbody_tpu/ops/pallas_forces_e64.py::_e64_kernel, which builds a
// correctly rounded binary64 softfloat out of uint32 lane ops because the
// TPU has no fp64. Hopper has binary64 in hardware, so the same chain runs
// in native doubles and is bit-identical to native/core.cc's dsqrt mode:
//
//   dx = q_j - q_i                       (likewise dy, dz)
//   d2 = ((dx*dx + dy*dy) + dz*dz) + eps2
//   d3 = d2 * sqrt(d2)                   (dsqrt; sqrt3: sqrt((d2*d2)*d2))
//   a_i += (gm_j * dx) / d3              for j = 0, 1, ..., n-1 in order
//
// Every operation is an explicit round-to-nearest intrinsic and the file is
// built with -fmad=false: nvcc contracts a*b+c into DFMA by default, and one
// fused rounding is enough to break bit equality with the serial core. The
// j == i term is +-0 (its numerator is 0) and is folded like any other:
// adding +-0 to the accumulator, which starts at +0 and never becomes -0
// under round-to-nearest, changes nothing.
//
// Layout: rows qi (B, ni, 3) against sources qj (B, nj, 3) with gmj (B, nj)
// = fl(G * m_eff), a (B, ni, 3), all contiguous float64. The self form is
// qi = qj. The grid is (ceil(ni / R), B): a block owns R rows of one
// scenario b, and scenarios never mix. Its force is the binary64 block
// force that the graded step B1' and simulate's step run too
// (f64_force.cuh): R * TJ compute threads write each tile's pair terms
// into a ring of shared term tiles, and one fold warp adds them in
// ascending j, lane (row, component), handed over by named barriers. A
// ragged last tile is masked, so any ni and nj work unpadded. A row's fold
// reads only its own position and the sources, so its bits do not depend
// on which rows share the launch or on the geometry: the row blocks of a
// mesh (parallel/solver_sharded.py), each launched on its own, give the
// self form's bits.
//
// The geometry is F64Block, 4 rows a block, so that a thousand rows
// (simulate's n = 1024, the graded batch's B = 2, the mesh's 512-row
// cross form) make 256 blocks for the 132 SMs and the fold's latency is
// paid in parallel.
//
// Bound: the fp64 pipe (40 fp64 instructions a pair in the SASS, one
// square root and one reciprocal among them: the three divisions by d3
// share the reciprocal, forces.cuh div_rn_with, with __ddiv_rn's bits)
// and the latency of the serial fold, which no reassociation may shorten.
// wgmma and TMA do not apply: there is no fp64 matrix product here and the
// tiles are a few KB.

#include <cuda_runtime.h>

#include "f64_force.cuh"

namespace {

using Geo = nbody::F64Block;

// dist3: the form of d2^1.5 (forces.cuh), a template argument, so the
// dsqrt instantiation is the same code whatever the other form costs
template <int dist3>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
accel_f64_kernel(const double* __restrict__ qi,
                 const double* __restrict__ qj, const double* __restrict__ gm,
                 double* __restrict__ a, int ni, int nj, double eps2) {
    __shared__ typename Geo::Smem sm;

    const int b = blockIdx.y, i0 = blockIdx.x * Geo::R;
    const int live = min(Geo::R, ni - i0);
    const size_t rows = (static_cast<size_t>(b) * ni + i0) * 3;
    nbody::f64_rows_qi<Geo>(qi + rows, live, sm);
    if (threadIdx.x < Geo::NC) {
        const nbody::F64Table sources{qj + static_cast<size_t>(b) * nj * 3,
                                      gm + static_cast<size_t>(b) * nj};
        nbody::f64_rows_terms<Geo, dist3>(sources, nj, live, eps2, sm);
        return;
    }
    int x;
    const bool folds = nbody::f64_fold_lane<Geo>(live, x);
    const double acc = nbody::f64_rows_fold<Geo>(nj, folds, sm);
    if (folds) a[rows + x] = acc;
}

// The pair term's division (forces.cuh div_rn_with, its reciprocal made
// once) beside __ddiv_rn on the same operands; where its `zero` form (the
// resident chunk's) gives other bits, got is want with every bit flipped
__global__ void __launch_bounds__(256)
div_probe_kernel(const double* __restrict__ n, const double* __restrict__ d,
                 double* __restrict__ want, double* __restrict__ got,
                 int count) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    const double w = __ddiv_rn(n[i], d[i]), r = nbody::rcp_for_div(d[i]);
    const double g = nbody::div_rn_with(n[i], d[i], r);
    const double z = nbody::div_rn_with<true>(n[i], d[i], r);
    want[i] = w;
    got[i] = __double_as_longlong(g) == __double_as_longlong(z)
                 ? g : __longlong_as_double(~__double_as_longlong(w));
}

}  // namespace

// a (B, ni, 3) of rows qi (B, ni, 3) from sources qj (B, nj, 3) under gm
// (B, nj). dist3: 1 dsqrt, 2 sqrt3 (native/core.cc's numbers); anything
// else, or an empty shape, returns cudaErrorInvalidValue without launching.
extern "C" int accel_f64_launch(const double* qi, const double* qj,
                                const double* gm, double* a, int B, int ni,
                                int nj, double eps2, int dist3,
                                void* stream) {
    if (B <= 0 || B > 65535 || ni <= 0 || nj <= 0  // B rides gridDim.y
        || (dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((ni + Geo::R - 1) / Geo::R, B);
    if (dist3 == nbody::DIST3_DSQRT)
        accel_f64_kernel<nbody::DIST3_DSQRT>
            <<<grid, Geo::THREADS, 0, s>>>(qi, qj, gm, a, ni, nj, eps2);
    else
        accel_f64_kernel<nbody::DIST3_SQRT3>
            <<<grid, Geo::THREADS, 0, s>>>(qi, qj, gm, a, ni, nj, eps2);
    return static_cast<int>(cudaGetLastError());
}

// want[i] = __ddiv_rn(n[i], d[i]) and got[i] the pair term's division of
// the same operands, i < count: chip_smoke.py phase 2 holds them bitwise
// equal. Returns the launch error, or cudaErrorInvalidValue for count < 1.
extern "C" int div_probe_launch(const double* n, const double* d,
                                double* want, double* got, int count,
                                void* stream) {
    if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
    div_probe_kernel<<<(count + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(n, d, want, got,
                                                            count);
    return static_cast<int>(cudaGetLastError());
}

// What the card says of B1's dsqrt instantiation: f64_force.cuh
// f64_kernel_info.
extern "C" int accel_f64_info(int* out) {
    return nbody::f64_kernel_info<Geo>(
        accel_f64_kernel<nbody::DIST3_DSQRT>, out);
}
