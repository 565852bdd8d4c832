// The graded step in double-double (B4'): kernel B4's force, the Euler
// update and the graded drivers' checks, one launch per step, for the
// graded solve at precision 'tf3' (graded.cuh has the chunk loop, the
// ping-pong buffers and the checks, all generic in the value type).
//
// Replaces, on the graded path, the JAX package's triple-float32 scans
// (nbody_tpu/models/direct_sum.py _p12_chunk, _p123_chunk, _p3_chunks with
// TF3 carries, whose force is ops/forces.py::pairwise_accel_tf3). Per step
// t and scenario row b, every quantity double-double:
//
//   gm_j = (m0_j + mh_j * fst[t]) * G
//   a_i  = fold over ascending j of B4's pair term (dd.cuh)
//   v_i' = v_i + a_i*dt;  q_i' = q_i + v_i'*dt
//
// and the checks compare double-double d2 with r2 = pr*pr and md2[t] =
// (fl64(speed*dt)*t)^2, as the JAX package's tf3 drivers build them
// (direct_sum.py:246-248, 282-284). Bitwise equal to the plain dd chunks
// of ops/graded_step.py, whose force is kernel B4.
//
// Layout: a block owns R rows of one scenario row (grid ceil(n / R) x B)
// and does for them kernel B4's block force (dd_force.cuh
// dd_rows_terms, dd_rows_fold): warp specialised, its compute threads taking RPT rows
// each with their pair terms interleaved, one fold warp keeping every row
// component's serial fold, then applying the Euler update to its
// component. gm_j is formed once a block and tile, a tile ahead, from the
// masses (GradedGm), not once a pair. Two geometries, by n (Wide and
// Narrow below): at n = 1024 8 rows a block put one block on each of 128
// SMs, and 11 compute warps leave the fold warp's scheduler two of them
// beside its serial adds; at small n a step is a few tiles, one thread's
// chain of divisions sets its time, and 4 rows a block, one a thread,
// keep that chain short.
//
// The mesh, the row-range form, as in graded_step_f64.cu: a launch takes
// the rows [r0, r0 + ni) of a state kept in k blocks of ni rows
// (blocks.cuh), reads every row as a source and writes its rows; one
// device is k = 1, r0 = 0, ni = n of the same kernel, in the
// instantiation that knows the sources lie in one block (Blocked = false),
// which a mesh of one body rank runs too.
// The geometry follows n, not ni, so every mesh shape runs the one-device
// geometry.
//
// Bound: the fp64 pipe, B4's 333 fp64 instructions a pair (the pair term
// 309, the fold 24; chip_smoke.py B4_INSTR_PER_PAIR, counted in the SASS
// by scripts/sass_count.py). What the bound leaves out: gm_j, 38
// instructions formed once a block for its R rows; the fold's adds, all
// on one scheduler; and each step's launch and checks. wgmma and TMA do
// not apply: there is no fp64 matrix product and a tile is a few KB.

#include <cuda_runtime.h>

#include "dd.cuh"
#include "dd_force.cuh"
#include "graded.cuh"

namespace {

using nbody::dd;
using nbody::GradedArgs;

constexpr int CHECK_THREADS = 256;

// Wide, above NARROW_MAX_N bodies: 8 rows a block (at B = 1, n = 1024,
// 128 blocks, one on each SM), two a thread, 88 columns a tile: 11
// compute warps and the fold warp, which lands on the SM's fourth
// scheduler beside two compute warps where the other three hold three
// each (a warp issues on scheduler warp % 4): the fold's serial adds
// take about the time of a compute warp's terms, so the four share the
// fp64 work about evenly. Narrow (dd_force.cuh, kernel B4's shape), up to
// NARROW_MAX_N bodies, where a step is a few tiles and the latency of one
// thread's chain sets its time: 4 rows a block, one a thread, 64 columns
// a tile, two blocks a SM.
using Wide = nbody::DdGeometry<8, 2, 88, 2, 1>;
using Narrow = nbody::DdNarrow;
constexpr int NARROW_MAX_N = 512;

// Source j's gm_j = (m0_j + mh_j * f) * G of scenario row b at step t (f =
// fst[t]), formed once a block and tile (graded.cuh graded_gm)
struct GradedGm {
    static constexpr bool STAGED = true;
    struct Raw {
        dd m0, mh;
    };
    const dd* __restrict__ m0;
    const dd* __restrict__ mh;
    dd f, G;
    __device__ __forceinline__ Raw load(int j) const { return {m0[j], mh[j]}; }
    __device__ __forceinline__ dd form(Raw r) const {
        return nbody::graded_gm(r.m0, r.mh, f, G);
    }
};

// Blocked: whether the state may lie in several blocks (the mesh)
template <class Geo, bool Blocked>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
graded_step_dd_kernel(GradedArgs<dd> a, const dd* __restrict__ q_in,
                      const dd* __restrict__ v_in, dd* __restrict__ q_out,
                      dd* __restrict__ v_out, int off, int check) {
    extern __shared__ __align__(16) unsigned char smem[];
    auto& sm = *reinterpret_cast<typename Geo::Smem*>(smem);
    const int t = nbody::graded_step_at(a, off);
    const int b = blockIdx.y, i0 = a.r0 + blockIdx.x * Geo::R, n = a.n;
    const int live = min(Geo::R, nbody::graded_end(a) - i0);
    if (check && blockIdx.x == 0 && b == 0)
        nbody::graded_check(a, const_cast<dd*>(q_in), const_cast<dd*>(v_in),
                            t - 1, false);
    if (live <= 0) return;  // a rank without rows: the checks only
    if (nbody::graded_frozen(a, b, t)) {
        nbody::copy_bodies(a, q_in, v_in, q_out, v_out, b, i0, Geo::R);
        return;
    }
    // scenario row src's sources from qb; the block's rows from qb + own,
    // written to the same place of scenario row b
    const int src = nbody::graded_source_row(a, b, t, check);
    const long long sb = 3LL * src * a.L.ni, own = a.L.at(0, i0);
    const long long ob = 3LL * b * a.L.ni + own;
    const dd* qb = q_in + sb;
    nbody::dd_rows_qi<Geo>(qb + own, live, sm);
    if (threadIdx.x < Geo::NC) {
        const size_t mb = static_cast<size_t>(b) * n;
        nbody::dd_rows_terms<Geo, GradedGm, Blocked>(
            qb, a.L, n, a.eps2,
            GradedGm{a.m0 + mb, a.mh + mb, a.fst[t], a.G}, sm);
        return;
    }
    // the fold warp; a lane reads its row component's state before the
    // fold and applies the Euler update after it
    int x;
    const bool folds = nbody::dd_fold_lane<Geo>(live, x);
    const dd q0 = folds ? qb[own + x] : dd{0.0, 0.0};
    const dd v0 = folds ? v_in[sb + own + x] : dd{0.0, 0.0};
    const dd acc = nbody::dd_rows_fold<Geo>(n, folds, sm);
    if (folds)
        nbody::graded_euler(acc, q0, v0, a.dt, q_out[ob + x], v_out[ob + x]);
}

__global__ void __launch_bounds__(CHECK_THREADS)
graded_check_dd_kernel(GradedArgs<dd> a, dd* q, dd* v, int off) {
    nbody::graded_check(a, q, v, nbody::graded_step_at(a, off), true);
}

using StepKernel = void (*)(GradedArgs<dd>, const dd*, const dd*, dd*, dd*,
                            int, int);

// The step kernel of geometry Geo, with its dynamic shared memory allowed
template <class Geo, bool Blocked = false>
cudaError_t step_kernel(StepKernel* kernel, size_t* smem) {
    *kernel = graded_step_dd_kernel<Geo, Blocked>;
    *smem = sizeof(typename Geo::Smem);
    return cudaFuncSetAttribute(*kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
}

// Steps s0 + 1 .. s0 + K in geometry Geo (graded.cuh graded_chunk)
template <class Geo>
int chunk_dd(const GradedArgs<dd>& a, dd* q, dd* v, dd* q2, dd* v2, int K,
             cudaStream_t stream, int* launched) {
    StepKernel kernel;
    size_t smem;
    const cudaError_t err = step_kernel<Geo>(&kernel, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.n + Geo::R - 1) / Geo::R, a.B);
    return nbody::graded_chunk(kernel, graded_check_dd_kernel, grid,
                               Geo::THREADS, CHECK_THREADS, a, q, v, q2, v2,
                               K, stream, launched, smem);
}

// One launch of a mesh rank in geometry Geo (graded.cuh
// graded_rows_launch); several blocks or one (one device's instantiation)
template <class Geo, bool Blocked>
int rows_dd(const GradedArgs<dd>& a, dd* qv, dd* qv_out, int off, int check,
            void* stream) {
    StepKernel kernel;
    size_t smem;
    const cudaError_t err = step_kernel<Geo, Blocked>(&kernel, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long half = a.L.stride / 2;   // a block's q rows, then v's
    return nbody::graded_rows_launch(
        kernel, graded_check_dd_kernel, Geo::R, Geo::THREADS, CHECK_THREADS,
        a, qv, qv + half, qv_out, qv_out ? qv_out + half : nullptr, off,
        check, static_cast<cudaStream_t>(stream), smem);
}

// graded_step_dd_info in geometry Geo
template <class Geo>
int info_dd(int* out) {
    StepKernel kernel;
    size_t smem;
    cudaFuncAttributes attr;
    int blocks = 0;
    cudaError_t err = step_kernel<Geo>(&kernel, &smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, Geo::THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int values[] = {attr.numRegs, static_cast<int>(attr.sharedSizeBytes),
                          static_cast<int>(smem),
                          static_cast<int>(attr.localSizeBytes),
                          Geo::THREADS, blocks, Geo::R, Geo::TJ, Geo::RPT,
                          NARROW_MAX_N};
    for (int k = 0; k < 10; ++k) out[k] = values[k];
    return 0;
}

}  // namespace

// Steps s0 + 1 .. s0 + K of a graded driver (mode 0 P12, 1 P3, 2 P123)
// from the state (q, v), (B, n, 3) double-double each as pairs of doubles;
// the result lies in (q, v) if K is even, else in (q2, v2). The real
// tables and carries are double-double too; G, dt, eps2 and r2 come as
// (hi, lo). Otherwise as graded_chunk_f64_launch.
extern "C" int graded_chunk_dd_launch(
        double* q, double* v, double* q2, double* v2, const double* m0,
        const double* mh, const double* fst, const double* md2,
        const long long* others, long long* arr, long long* arr2,
        long long* hit, unsigned char* flag, double* min_d2, double* q_snap,
        double* v_snap, int mode, int B, int n, int D, int planet,
        double G_hi, double G_lo, double dt_hi, double dt_lo, double eps2_hi,
        double eps2_lo, double r2_hi, double r2_lo, const int* s0, int K,
        int* launched, void* stream) {
    if (!nbody::graded_args_ok(mode, B, n, D, s0, K) || launched == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    *launched = 0;
    auto d = [](double* p) { return reinterpret_cast<dd*>(p); };
    auto cd = [](const double* p) { return reinterpret_cast<const dd*>(p); };
    const GradedArgs<dd> a = nbody::graded_args(
        cd(m0), cd(mh), cd(fst), cd(md2), others, arr, arr2, hit, flag,
        d(min_d2), d(q_snap), d(v_snap), mode, B, n, D, planet,
        dd{G_hi, G_lo}, dd{dt_hi, dt_lo}, dd{eps2_hi, eps2_lo},
        dd{r2_hi, r2_lo}, s0);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return n <= NARROW_MAX_N
               ? chunk_dd<Narrow>(a, d(q), d(v), d(q2), d(v2), K, s, launched)
               : chunk_dd<Wide>(a, d(q), d(v), d(q2), d(v2), K, s, launched);
}

// One launch of a mesh rank in double-double: graded_rows_f64_step's
// arguments (graded_step_f64.cu) as pairs of doubles, with G, dt, eps2
// and r2 as (hi, lo), and no dist3
extern "C" int graded_rows_dd_step(
        const double* m0, const double* mh, const double* fst,
        const double* md2, const long long* others, long long* arr,
        long long* arr2, long long* hit, unsigned char* flag, double* min_d2,
        double* q_snap, double* v_snap, int mode, int B, int n, int D,
        int planet, int p1, int p2, int ni, int k, double G_hi, double G_lo,
        double dt_hi, double dt_lo, double eps2_hi, double eps2_lo,
        double r2_hi, double r2_lo, double* qv, double* qv_out, int r0,
        const int* s0, int off, int check, void* stream) {
    auto d = [](double* p) { return reinterpret_cast<dd*>(p); };
    auto cd = [](const double* p) { return reinterpret_cast<const dd*>(p); };
    GradedArgs<dd> a = nbody::graded_args(
        cd(m0), cd(mh), cd(fst), cd(md2), others, arr, arr2, hit, flag,
        d(min_d2), d(q_snap), d(v_snap), mode, B, n, D, planet,
        dd{G_hi, G_lo}, dd{dt_hi, dt_lo}, dd{eps2_hi, eps2_lo},
        dd{r2_hi, r2_lo}, s0);
    if (!nbody::graded_rows_args(a, p1, p2, ni, k, r0, off,
                                 qv_out != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    dd* in = d(qv);
    dd* out = d(qv_out);
    if (n <= NARROW_MAX_N)
        return k > 1 ? rows_dd<Narrow, true>(a, in, out, off, check, stream)
                     : rows_dd<Narrow, false>(a, in, out, off, check, stream);
    return k > 1 ? rows_dd<Wide, true>(a, in, out, off, check, stream)
                 : rows_dd<Wide, false>(a, in, out, off, check, stream);
}

// What the card says about the step kernel as it runs at n bodies, into
// out[10]: registers a thread, static and dynamic shared memory a block
// (bytes), local memory a thread (bytes; spills land there), threads a
// block, blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), then the geometry: rows
// a block, columns a tile, rows a compute thread; last the largest n of
// the narrow geometry. Returns the CUDA error, or 0.
extern "C" int graded_step_dd_info(int n, int* out) {
    return n <= NARROW_MAX_N ? info_dd<Narrow>(out) : info_dd<Wide>(out);
}
