// The graded step in binary64: kernel B1's force, the Euler update and the
// graded drivers' checks, one launch per step (graded.cuh has the chunk
// loop and the checks).
//
// Replaces, on the graded path, nbody_tpu/ops/pallas_forces_e64.py::
// _e64_kernel together with the per-step work around it that the JAX
// package compiles into one scan per chunk (nbody_tpu/models/direct_sum.py
// _p12_chunk, _p123_chunk, _p3_chunks). Per step t and scenario row b:
//
//   gm_j = fl(fl(m0_j + fl(mh_j * fst[t])) * G)
//   a_i  = fold over ascending j of B1's pair term (forces.cuh)
//   v_i' = v_i + a_i*dt;  q_i' = q_i + v_i'*dt
//
// every op a round-to-nearest intrinsic (and -fmad=false), so the result is
// bit-equal to kernel B1 plus the PyTorch ops of the drivers' plain chunk
// (ops/graded_step.py) and to native/core.cc in the same dist3 mode (dsqrt
// or sqrt3, one instantiation each).
//
// Layout: a block owns R rows of one scenario row b (grid ceil(n / R) x B;
// at n = 1024 that is 256 blocks a row, about two per SM). Its force is
// the binary64 block force (f64_force.cuh, geometry F64Block): R * TJ
// compute threads write a tile's pair terms into a ring of NBUF shared
// term tiles, and one fold warp, lane (row, component), adds them in
// ascending j into a register, the serial order the contract fixes; gm_j
// is formed from the masses a pair. The fold lane then applies the Euler
// update to its component. Kernel B1 runs on the same block force.
//
// The mesh, the row-range form: a launch takes the rows [r0, r0 + ni)
// of a state kept in k blocks of ni rows (blocks.cuh, the layout the
// mesh's all_gather makes), reads every row as a source, and writes its
// rows into the same place of the other buffer; block (0, 0) checks the
// previous step on the whole state. One device is the case k = 1, r0 = 0,
// ni = n of the same kernel, in the instantiation Blocked = false, which
// knows that the sources lie in one block, as does a mesh of one body
// rank; Blocked = true (k > 1) walks them with a BlockCursor (a compare
// and an add a pair, no division). The walk in
// the one-device path cost it 3.5% at B=1, and at B=2 27% through its
// registers (58: three blocks an SM where 54 to 56 leave four), on an
// "NVIDIA H100 80GB HBM3, 700.00 W"; the instantiation that knows is
// within 1%.
//
// Bound: the fold's latency and the fp64 pipe. Each row component is a
// chain of n dependent fp64 adds, which no reassociation may shorten (at
// n = 1024 about 5 us on the card, chip_smoke.py phase 2's fold probe);
// the n^2 pair terms take 40 fp64 instructions each (2.5 us at the fp64
// issue rate), a square root and three divisions by one shared reciprocal
// among them (forces.cuh div_rn_with). A step
// costs them plus the launch. wgmma and TMA do not apply: there is no fp64
// matrix product and a tile is a few KB.

#include <cuda_runtime.h>

#include "f64_force.cuh"
#include "graded.cuh"

namespace {

using nbody::GradedArgs;
using Geo = nbody::F64Block;

constexpr int CHECK_THREADS = 256;

// B1''s sources: scenario row b's positions qb in the state's layout and
// gm_j = fl(fl(m0_j + fl(mh_j * f)) * G) formed a pair
template <bool Blocked>
struct GradedSources {
    const double* __restrict__ qb;
    const double* __restrict__ m0;   // (n,) of the row
    const double* __restrict__ mh;
    double f, G;
    nbody::Blocks L;
    using Cursor = nbody::BlockCursor;
    __device__ __forceinline__ Cursor cursor(int jj) const {
        return Cursor(L, jj);
    }
    __device__ __forceinline__ const double* pos(Cursor& cur, int j) const {
        return qb + nbody::source_at<Blocked>(cur, L, j);
    }
    __device__ __forceinline__ double gm_of(int j) const {
        return nbody::graded_gm(m0[j], mh[j], f, G);
    }
};

// dist3: the form of d2^1.5 (forces.cuh), a template argument, so the
// dsqrt instantiation is the same code whatever the other form costs;
// Blocked: whether the state may lie in several blocks (the mesh)
template <int dist3, bool Blocked>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
graded_step_f64_kernel(GradedArgs<double> a, const double* __restrict__ q_in,
                       const double* __restrict__ v_in,
                       double* __restrict__ q_out, double* __restrict__ v_out,
                       int off, int check) {
    __shared__ Geo::Smem sm;

    const int t = nbody::graded_step_at(a, off);
    const int b = blockIdx.y, i0 = a.r0 + blockIdx.x * Geo::R;
    const int n = a.n, live = min(Geo::R, nbody::graded_end(a) - i0);
    if (check && blockIdx.x == 0 && b == 0)
        nbody::graded_check(a, const_cast<double*>(q_in),
                            const_cast<double*>(v_in), t - 1, false);
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
    const double* qb = q_in + sb;
    const size_t mb = static_cast<size_t>(b) * n;
    nbody::f64_rows_qi<Geo>(qb + own, live, sm);
    if (threadIdx.x < Geo::NC) {
        const GradedSources<Blocked> sources{qb, a.m0 + mb, a.mh + mb,
                                             a.fst[t], a.G, a.L};
        nbody::f64_rows_terms<Geo, dist3>(sources, n, live, a.eps2, sm);
        return;
    }
    int x;
    const bool folds = nbody::f64_fold_lane<Geo>(live, x);
    const double q0 = folds ? qb[own + x] : 0.0;
    const double v0 = folds ? v_in[sb + own + x] : 0.0;
    const double acc = nbody::f64_rows_fold<Geo>(n, folds, sm);
    if (folds)
        nbody::graded_euler(acc, q0, v0, a.dt, q_out[ob + x], v_out[ob + x]);
}

__global__ void __launch_bounds__(CHECK_THREADS)
graded_check_f64_kernel(GradedArgs<double> a, double* q, double* v,
                        int off) {
    nbody::graded_check(a, q, v, nbody::graded_step_at(a, off), true);
}

// One warp folds n <= 1024 values from shared memory, reps times over, in
// one chain of dependent adds per lane: the latency floor of kernel B1's
// fold (n adds a row component), timed on the card's global timer.
__global__ void __launch_bounds__(32)
fold_floor_f64_kernel(const double* __restrict__ x, double* __restrict__ out,
                      long long* __restrict__ ns, int n, int reps) {
    __shared__ double s_x[1024];
    for (int j = threadIdx.x; j < n; j += 32) s_x[j] = x[j];
    __syncwarp();
    double acc = 0.0;
    unsigned long long t0, t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0)::"memory");
    for (int r = 0; r < reps; ++r)
        for (int j = 0; j < n; ++j) acc = __dadd_rn(acc, s_x[j]);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1)::"memory");
    out[threadIdx.x] = acc;
    if (threadIdx.x == 0) *ns = static_cast<long long>(t1 - t0);
}

}  // namespace

// Steps s0 + 1 .. s0 + K of a graded driver (mode 0 P12, 1 P3, 2 P123)
// from the state (q, v), (B, n, 3) each, s0 read on the card from the
// device word `s0` (graded.cuh: a CUDA graph of this call serves every
// chunk of K steps); the result lies in (q, v) if K is even, else in (q2,
// v2). arr2 is the second arrival buffer (see graded.cuh), equal to arr on
// entry; the arrivals of step s0 + K lie in both on return. Pointers a
// mode does not use may be null. dist3: 1 dsqrt, 2 sqrt3 (native/core.cc's
// numbers). Returns the first launch error, or cudaErrorInvalidValue
// without launching.
extern "C" int graded_chunk_f64_launch(
        double* q, double* v, double* q2, double* v2, const double* m0,
        const double* mh, const double* fst, const double* md2,
        const long long* others, long long* arr, long long* arr2,
        long long* hit, unsigned char* flag, double* min_d2, double* q_snap,
        double* v_snap, int mode, int B, int n, int D, int planet, int dist3,
        double G, double dt, double eps2, double r2, const int* s0, int K,
        void* stream) {
    if (!nbody::graded_args_ok(mode, B, n, D, s0, K)
        || (dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3))
        return static_cast<int>(cudaErrorInvalidValue);
    const GradedArgs<double> a = nbody::graded_args(
        m0, mh, fst, md2, others, arr, arr2, hit, flag, min_d2, q_snap,
        v_snap, mode, B, n, D, planet, G, dt, eps2, r2, s0);
    const dim3 grid((n + Geo::R - 1) / Geo::R, B);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dist3 == nbody::DIST3_DSQRT)
        return nbody::graded_chunk(
            graded_step_f64_kernel<nbody::DIST3_DSQRT, false>,
            graded_check_f64_kernel, grid, Geo::THREADS, CHECK_THREADS, a,
            q, v, q2, v2, K, s);
    return nbody::graded_chunk(
        graded_step_f64_kernel<nbody::DIST3_SQRT3, false>,
        graded_check_f64_kernel, grid, Geo::THREADS, CHECK_THREADS, a, q, v,
        q2, v2, K, s);
}

// One launch of a mesh rank (graded.cuh graded_rows_launch): step t =
// *s0 + off (s0 a device word, as graded_chunk_f64_launch reads it) of
// the rows [r0, r0 + ni) of the state qv, kept in k blocks of ni =
// ceil(n / k) rows, block r holding q then v of its rows in every
// scenario row, (k, 2, B, ni, 3); the launch reads all of qv and writes
// its rows to the same place of qv_out, after the checks of step t - 1 on
// qv if `check`. With qv_out null, the checks of step t on qv alone. p1,
// p2: the rows of P1 and P2 in P12 (-1 where absent), -1 in P3. The other
// arguments are graded_chunk_f64_launch's. At k = 1 the state is one
// block, and the launch is the one-device instantiation. Returns the
// launch error, or cudaErrorInvalidValue without launching.
extern "C" int graded_rows_f64_step(
        const double* m0, const double* mh, const double* fst,
        const double* md2, const long long* others, long long* arr,
        long long* arr2, long long* hit, unsigned char* flag, double* min_d2,
        double* q_snap, double* v_snap, int mode, int B, int n, int D,
        int planet, int p1, int p2, int ni, int k, int dist3, double G,
        double dt, double eps2, double r2, double* qv, double* qv_out,
        int r0, const int* s0, int off, int check, void* stream) {
    GradedArgs<double> a = nbody::graded_args(
        m0, mh, fst, md2, others, arr, arr2, hit, flag, min_d2, q_snap,
        v_snap, mode, B, n, D, planet, G, dt, eps2, r2, s0);
    if ((dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3)
        || !nbody::graded_rows_args(a, p1, p2, ni, k, r0, off,
                                    qv_out != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long half = a.L.stride / 2;   // a block's q rows, then v's
    using StepKernel = void (*)(GradedArgs<double>, const double*,
                                const double*, double*, double*, int, int);
    const bool dsqrt = dist3 == nbody::DIST3_DSQRT;
    const StepKernel step =
        k > 1 ? (dsqrt ? &graded_step_f64_kernel<nbody::DIST3_DSQRT, true>
                       : &graded_step_f64_kernel<nbody::DIST3_SQRT3, true>)
              : (dsqrt ? &graded_step_f64_kernel<nbody::DIST3_DSQRT, false>
                       : &graded_step_f64_kernel<nbody::DIST3_SQRT3, false>);
    return nbody::graded_rows_launch(
        step, graded_check_f64_kernel, Geo::R, Geo::THREADS, CHECK_THREADS,
        a, qv,
        qv + half, qv_out, qv_out ? qv_out + half : nullptr, off, check,
        static_cast<cudaStream_t>(stream));
}

// What the card says of the one-device dsqrt step kernel
// (f64_force.cuh f64_kernel_info).
extern "C" int graded_step_f64_info(int* out) {
    return nbody::f64_kernel_info<Geo>(
        graded_step_f64_kernel<nbody::DIST3_DSQRT, false>, out);
}

extern "C" int fold_floor_f64_launch(const double* x, double* out,
                                     long long* ns, int n, int reps,
                                     void* stream) {
    if (n <= 0 || n > 1024 || reps <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    fold_floor_f64_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out, ns, n, reps);
    return static_cast<int>(cudaGetLastError());
}
