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
// at n = 1024 that is 256 blocks a row, about two per SM). It is warp
// specialised. R * TJ compute threads, one per (row, column) of a TJ-wide
// source tile, write the tile's pair terms into a ring of NBUF shared term
// tiles; one fold warp takes the tiles in order, and its lane (row,
// component) adds a tile's TJ terms in ascending j into a register, the
// serial order the contract fixes. The two sides hand the tiles over with
// named barriers (full[buf], empty[buf]): the fold of tile k overlaps the
// terms of the tiles after it, and no barrier stops the whole block. The
// fold lane then applies the Euler update to its component. B1 put 16
// rows in a 256-thread block (64 blocks at B = 1), three barriers a tile,
// and let 208 of its threads idle while 48 folded.
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
// the n^2 pair terms take 46 fp64 instructions each (2.8 us at the fp64
// issue rate), a third of them in one sqrt and three divisions. A step
// costs them plus the launch. wgmma and TMA do not apply: there is no fp64
// matrix product and a tile is a few KB.

#include <cuda_runtime.h>

#include "forces.cuh"
#include "graded.cuh"

namespace {

using nbody::GradedArgs;

constexpr int R = 4;             // rows per block
constexpr int TJ = 64;           // columns per tile
constexpr int NBUF = 4;          // term tiles in flight
constexpr int NC = R * TJ;       // compute threads, one pair each a tile
constexpr int THREADS = NC + 32; // and one fold warp
constexpr int CHECK_THREADS = 256;
constexpr int BAR_FULL = 1;          // named barriers: tile buf is written
constexpr int BAR_EMPTY = 1 + NBUF;  // tile buf is folded
static_assert(2 * NBUF < 16, "named barriers 1..15");
static_assert(3 * R <= 32, "one fold lane per row and component");

__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// dist3: the form of d2^1.5 (forces.cuh), a template argument, so the
// dsqrt instantiation is the same code whatever the other form costs;
// Blocked: whether the state may lie in several blocks (the mesh)
template <int dist3, bool Blocked>
__global__ void __launch_bounds__(THREADS, 2)
graded_step_f64_kernel(GradedArgs<double> a, const double* __restrict__ q_in,
                       const double* __restrict__ v_in,
                       double* __restrict__ q_out, double* __restrict__ v_out,
                       int t, int check) {
    __shared__ double s_qi[3][R];
    __shared__ double s_term[NBUF][3][R][TJ + 1];  // +1: no bank conflicts

    const int b = blockIdx.y, i0 = a.r0 + blockIdx.x * R, tid = threadIdx.x;
    const int n = a.n, live = min(R, nbody::graded_end(a) - i0);
    if (check && blockIdx.x == 0 && b == 0)
        nbody::graded_check(a, const_cast<double*>(q_in),
                            const_cast<double*>(v_in), t - 1, false);
    if (live <= 0) return;  // a rank without rows: the checks only
    if (nbody::graded_frozen(a, b, t)) {
        nbody::copy_bodies(a, q_in, v_in, q_out, v_out, b, i0, R);
        return;
    }
    // scenario row src's sources from qb; the block's rows from qb + own,
    // written to the same place of scenario row b
    const int src = nbody::graded_source_row(a, b, t, check);
    const long long sb = 3LL * src * a.L.ni, own = a.L.at(0, i0);
    const long long ob = 3LL * b * a.L.ni + own;
    const double* qb = q_in + sb;
    const size_t mb = static_cast<size_t>(b) * n;
    const double f = a.fst[t];
    if (tid < 3 * R) {
        const int r = tid / 3, c = tid % 3;
        s_qi[c][r] = r < live ? qb[own + 3 * r + c] : 0.0;
    }
    __syncthreads();

    const int tiles = (n + TJ - 1) / TJ;
    if (tid < NC) {
        // compute threads: the pair (row r, column jj) of every tile
        const int r = tid / TJ, jj = tid % TJ;
        const double xi = s_qi[0][r], yi = s_qi[1][r], zi = s_qi[2][r];
        const bool row_live = r < live;
        nbody::BlockCursor cur(a.L, jj);
        for (int k = 0; k < tiles; ++k) {
            const int buf = k % NBUF;
            if (k >= NBUF) bar_sync(BAR_EMPTY + buf, THREADS);
            const int j = k * TJ + jj;
            if (row_live && j < n) {
                const double* qj = qb + nbody::source_at<Blocked>(cur, a.L, j);
                nbody::b1_pair_term<dist3>(
                    qj[0], qj[1], qj[2],
                    nbody::graded_gm(a.m0[mb + j], a.mh[mb + j], f, a.G),
                    xi, yi, zi, a.eps2, s_term[buf][0][r][jj],
                    s_term[buf][1][r][jj], s_term[buf][2][r][jj]);
            }
            bar_arrive(BAR_FULL + buf, THREADS);
        }
        return;
    }
    // the fold warp: lane (fr, fc) folds component fc of row fr
    const int lane = tid - NC, fr = lane / 3, fc = lane % 3;
    const bool folds = lane < 3 * R && fr < live;
    const int x = 3 * fr + fc;
    const double q0 = folds ? qb[own + x] : 0.0;
    const double v0 = folds ? v_in[sb + own + x] : 0.0;
    double acc = 0.0;
    for (int k = 0; k < tiles; ++k) {
        const int buf = k % NBUF;
        const int cols = min(TJ, n - k * TJ);
        bar_sync(BAR_FULL + buf, THREADS);
        if (folds) {
            const double* term = s_term[buf][fc][fr];
#pragma unroll 8
            for (int jj = 0; jj < cols; ++jj) acc = __dadd_rn(acc, term[jj]);
        }
        if (k + NBUF < tiles) bar_arrive(BAR_EMPTY + buf, THREADS);
    }
    if (folds)
        nbody::graded_euler(acc, q0, v0, a.dt, q_out[ob + x], v_out[ob + x]);
}

__global__ void __launch_bounds__(CHECK_THREADS)
graded_check_f64_kernel(GradedArgs<double> a, double* q, double* v, int p) {
    nbody::graded_check(a, q, v, p, true);
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

// Steps s0 + 1 .. s1 of a graded driver (mode 0 P12, 1 P3, 2 P123) from
// the state (q, v), (B, n, 3) each; the result lies in (q, v) if s1 - s0 is
// even, else in (q2, v2). arr2 is the second arrival buffer (see
// graded.cuh), equal to arr on entry. Pointers a mode does not use may be
// null. dist3: 1 dsqrt, 2 sqrt3 (native/core.cc's numbers). Returns the
// first launch error, or cudaErrorInvalidValue without launching.
extern "C" int graded_chunk_f64_launch(
        double* q, double* v, double* q2, double* v2, const double* m0,
        const double* mh, const double* fst, const double* md2,
        const long long* others, long long* arr, long long* arr2,
        long long* hit, unsigned char* flag, double* min_d2, double* q_snap,
        double* v_snap, int mode, int B, int n, int D, int planet, int dist3,
        double G, double dt, double eps2, double r2, int s0, int s1,
        void* stream) {
    if (!nbody::graded_args_ok(mode, B, n, D, s0, s1)
        || (dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3))
        return static_cast<int>(cudaErrorInvalidValue);
    const GradedArgs<double> a = nbody::graded_args(
        m0, mh, fst, md2, others, arr, arr2, hit, flag, min_d2, q_snap,
        v_snap, mode, B, n, D, planet, G, dt, eps2, r2);
    const dim3 grid((n + R - 1) / R, B);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dist3 == nbody::DIST3_DSQRT)
        return nbody::graded_chunk(
            graded_step_f64_kernel<nbody::DIST3_DSQRT, false>,
            graded_check_f64_kernel, grid, THREADS, CHECK_THREADS, a, q, v,
            q2, v2, s0, s1, s);
    return nbody::graded_chunk(
        graded_step_f64_kernel<nbody::DIST3_SQRT3, false>,
        graded_check_f64_kernel, grid, THREADS, CHECK_THREADS, a, q, v, q2,
        v2, s0, s1, s);
}

// One launch of a mesh rank (graded.cuh graded_rows_launch): step t of
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
        int r0, int t, int check, void* stream) {
    GradedArgs<double> a = nbody::graded_args(
        m0, mh, fst, md2, others, arr, arr2, hit, flag, min_d2, q_snap,
        v_snap, mode, B, n, D, planet, G, dt, eps2, r2);
    if ((dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3)
        || !nbody::graded_rows_args(a, p1, p2, ni, k, r0, t,
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
        step, graded_check_f64_kernel, R, THREADS, CHECK_THREADS, a, qv,
        qv + half, qv_out, qv_out ? qv_out + half : nullptr, t, check,
        static_cast<cudaStream_t>(stream));
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
