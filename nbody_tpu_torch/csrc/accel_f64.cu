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
// scenario b, and scenarios never mix. For each tile of TJ sources, in
// ascending order, the block stages q_j and gm_j in shared memory, all
// threads compute the R x TJ pair terms in parallel into shared memory, and
// then 3R threads (one per row and component) fold their row's TJ terms
// serially into a register. This is the split the TPU kernel's sub_j stacks
// make. A ragged last tile is masked in the fold, so any ni and nj work
// unpadded. A row's fold reads only its own position and the sources, so
// its bits do not depend on which rows share the launch: the row blocks of
// a mesh (parallel/solver_sharded.py), each launched on its own, give the
// self form's bits.
//
// Bound: the fp64 pipe (each pair costs one sqrt and three divisions, which
// Hopper runs as multi-instruction sequences) and the latency of the serial
// fold, which no reassociation may shorten. wgmma and TMA do not apply:
// there is no fp64 matrix product here and the tiles are a few KB. Speed is
// later work; this kernel is the simple, right one.

#include <cuda_runtime.h>

#include "forces.cuh"

namespace {

constexpr int R = 16;         // rows i per block
constexpr int TJ = 64;        // columns j per tile
constexpr int THREADS = 256;  // R * TJ / THREADS = 4 pair terms per thread
static_assert(THREADS >= 4 * TJ, "one staging load per thread");
static_assert(THREADS >= 3 * R, "one fold thread per row and component");

// dist3: the form of d2^1.5 (forces.cuh), a template argument, so the
// dsqrt instantiation is the same code whatever the other form costs
template <int dist3>
__global__ void __launch_bounds__(THREADS)
accel_f64_kernel(const double* __restrict__ qi,
                 const double* __restrict__ qj, const double* __restrict__ gm,
                 double* __restrict__ a, int ni, int nj, double eps2) {
    __shared__ double s_qj[3][TJ];
    __shared__ double s_gm[TJ];
    __shared__ double s_qi[3][R];
    __shared__ double s_term[3][R][TJ + 1];  // +1: fewer bank conflicts

    const int b = blockIdx.y;
    const int i0 = blockIdx.x * R;
    const int tid = threadIdx.x;
    const double* qib = qi + static_cast<size_t>(b) * ni * 3;
    const double* qb = qj + static_cast<size_t>(b) * nj * 3;
    const double* gb = gm + static_cast<size_t>(b) * nj;

    if (tid < 3 * R) {
        const int r = tid / 3, c = tid % 3;
        if (i0 + r < ni)
            s_qi[c][r] = qib[static_cast<size_t>(i0 + r) * 3 + c];
    }
    // fold thread: component fc of row fr
    const int fc = tid / R, fr = tid % R;
    double acc = 0.0;

    for (int j0 = 0; j0 < nj; j0 += TJ) {
        const int cols = min(TJ, nj - j0);
        __syncthreads();  // the previous tile's terms are folded
        if (tid < 3 * TJ) {
            const int c = tid / TJ, jj = tid % TJ;
            if (jj < cols)
                s_qj[c][jj] = qb[static_cast<size_t>(j0 + jj) * 3 + c];
        } else if (tid < 4 * TJ) {
            const int jj = tid - 3 * TJ;
            if (jj < cols) s_gm[jj] = gb[j0 + jj];
        }
        __syncthreads();

        for (int p = tid; p < R * TJ; p += THREADS) {
            const int r = p / TJ, jj = p % TJ;
            if (i0 + r >= ni || jj >= cols) continue;
            nbody::b1_pair_term<dist3>(
                s_qj[0][jj], s_qj[1][jj], s_qj[2][jj], s_gm[jj], s_qi[0][r],
                s_qi[1][r], s_qi[2][r], eps2, s_term[0][r][jj],
                s_term[1][r][jj], s_term[2][r][jj]);
        }
        __syncthreads();

        if (tid < 3 * R) {
            for (int jj = 0; jj < cols; ++jj)
                acc = __dadd_rn(acc, s_term[fc][fr][jj]);
        }
    }
    if (tid < 3 * R && i0 + fr < ni)
        a[(static_cast<size_t>(b) * ni + i0 + fr) * 3 + fc] = acc;
}

}  // namespace

// a (B, ni, 3) of rows qi (B, ni, 3) from sources qj (B, nj, 3) under gm
// (B, nj). dist3: 1 dsqrt, 2 sqrt3 (native/core.cc's numbers); anything
// else, or an empty shape, returns cudaErrorInvalidValue without launching.
extern "C" int accel_f64_launch(const double* qi, const double* qj,
                                const double* gm, double* a, int B, int ni,
                                int nj, double eps2, int dist3,
                                void* stream) {
    if (B <= 0 || B > 65535 || ni <= 0 || nj <= 0)  // B rides gridDim.y
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((ni + R - 1) / R, B);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dist3 == nbody::DIST3_DSQRT)
        accel_f64_kernel<nbody::DIST3_DSQRT><<<grid, THREADS, 0, s>>>(
            qi, qj, gm, a, ni, nj, eps2);
    else if (dist3 == nbody::DIST3_SQRT3)
        accel_f64_kernel<nbody::DIST3_SQRT3><<<grid, THREADS, 0, s>>>(
            qi, qj, gm, a, ni, nj, eps2);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
