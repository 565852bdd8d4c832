// The graded step in binary64: kernel B1's force, the Euler update and the
// graded drivers' checks, one launch per step (graded.cuh has the chunk
// loop and the checks); the fused driver's chunk at small n one launch
// (the resident chunk, below).
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
// Layout: a block owns R rows of one scenario row b (grid ceil(n / R) x
// B). Its force is a warp-specialised block force (f64_force.cuh): compute
// threads write a tile's pair terms into a ring of NBUF shared term
// tiles, and one fold warp, lane (row, component), adds them in ascending
// j into a register, the serial order the contract fixes; the fold lane
// then applies the Euler update to its component. The compute threads
// are B1''s own producer (F64Producer): RT rows a thread against each
// source, the source and its masses loaded a tile ahead, and zero
// numerators (a row's pair with itself, a massless device, a destroyed
// one) returned without __ddiv_rn's slow-path call. The geometry (R, RT,
// TJ, NBUF) is chosen by shape (b1_geometry): blocks of two rows where
// they fill the card once, of four where they do not, one tile of 64
// columns at most 64 sources.
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
// Bound: the fold's latency, the fp64 pipe and the kernel boundary. Each
// row component is a chain of n dependent fp64 adds, which no
// reassociation may shorten (at n = 1024 5.1 us on the card, chip_smoke.py
// phase 2's fold probe); the n^2 pair terms take 40 fp64 instructions each
// (2.5 us at B = 1 at the fp64 issue rate), a square root and three
// divisions by one shared reciprocal among them (forces.cuh
// b1_pair_terms). Measured (chip_smoke.py phase 17, "NVIDIA H100 80GB
// HBM3, 700.00 W", n = 1024, graph replays): kernel B1's producer made
// the terms slower than the fold could add them (12.2 us a step with no
// adds at B = 1, of 13.8), and its fold loop ran at twice the probe's 5.1
// us; with B1''s producer and the fold's tile unrolled a step takes 10.3
// us at B = 1, fold-bound (9.3 with no terms past the ring), and 14.8 at
// B = 2, producer-bound (12.3 with no adds). A chunk of frozen rows, the
// kernel boundary and a block's set-up, costs 2.9 us a step. wgmma and
// TMA do not apply: there is no fp64 matrix product and a tile is a few
// KB.
//
// The resident chunk. Up to RESIDENT_MAX_N bodies and RES_MAX_ROWS rows,
// where a block's part fits its shared memory, a chunk of K steps of the
// fused driver (P123: rows P1, P2, then one a device) is one launch: a
// thread block cluster of one block a scenario row, each keeping its
// row's carry in shared memory (q and v in a ping-pong pair, the masses,
// gm_j of the step: graded_gm, formed once a source and step, the bits of
// the per-pair form) and its own copy of the decision carries (the
// arrivals by parity, the hit, the min d2, the Problem-3 flags). A step
// touches no global memory but the tables fst and md2, which nothing
// writes (read a step ahead, their lines prefetched into L1 further
// ahead), and a barrier of the cluster:
//   terms  every (body i, source j) pair's B1 term (forces.cuh
//          b1_pair_term, its divisions returning a zero numerator's
//          quotient without __ddiv_rn's slow-path call: the same bits)
//          into shared memory, G compute threads a body; beside them the
//          check warp runs the checks of the step before (graded_check,
//          as block (0, 0) of the launch-a-step path runs them) on the
//          bodies they read of every row (planet, asteroid, devices),
//          which every block sent it: all blocks make the same checks on
//          the same bodies, so their carries agree without a collective
//          (the mesh's design);
//   fold   lane (body, component) adds its n terms over ascending j from
//          +0, then the Euler update (graded_euler) into the other
//          buffer; a checked body's lanes store their component into
//          every block's shared memory (distributed shared memory), and
//          the P2 row's lanes their state into the rows still pending,
//          which read it in place of their own at the next step, as the
//          launch-a-step path does (graded_source_row); gm_j of the next
//          step.
// Nothing is read from another block: what a step needs arrives by
// stores before the cluster's barrier. That holds the blocks together
// only while a Problem-3 row is pending (its missile has not arrived):
// once every block has seen every arrival, the rows depend on nothing
// but themselves, and a block stores its checked bodies into its own
// shared memory and takes a block barrier; its checks are then right
// for the carries its row decides (P1's min d2, P2's hit and arrivals, a
// Problem-3 row's flag), which it alone writes back. After the last step
// the closing checks, a pending row takes the P2 row's state, and each
// block writes its row back once under the chunk's contract (the result
// in (q2, v2) for an odd K), the arrivals in both buffers.
//
// It replaces, for the fused scan nbody_tpu/models/direct_sum.py::
// _p123_chunk with _e64_kernel inside, K step launches and a check launch.
// Bound: a block's fp64 pipe over its row's n^2 pairs, 40 instructions a
// pair (at n = 20, 250 cycles, about 0.13 us), and the latency of one
// pair's chain and of the fold's n dependent adds, where the
// launch-a-step path pays a kernel boundary a step (about 1.1 us under a
// graph), its loads through L2 and block (0, 0)'s checks before its rows.
// On an "NVIDIA H100 80GB HBM3, 700.00 W" at n = 20, B = 5 a step took
// 1.49 us against that path's 4.27 to 4.34; one block for all rows (tried
// first) 4.07, a cluster barrier every step 1.95. The resident chunk
// loses where a block's pair work outgrows the boundary: at n = 60 4.23
// us against 4.94, at 64 4.89 against 4.66, so RESIDENT_MAX_N = 60
// (chip_smoke.py phase 16; PERF.md section 6).

#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <algorithm>

#include "f64_force.cuh"
#include "graded.cuh"

namespace {

namespace cg = cooperative_groups;

using nbody::GradedArgs;

constexpr int CHECK_THREADS = 256;

// B1''s sources (f64_force.cuh f64_rows_terms_rt): scenario row b's
// positions qb in the state's layout and its masses, source j a position
// and (m0_j, mh_j), gm_j = fl(fl(m0_j + fl(mh_j * f)) * G) (graded_gm)
template <bool Blocked>
struct GradedSources {
    const double* __restrict__ qb;
    const double* __restrict__ m0;   // (n,) of the row
    const double* __restrict__ mh;
    double f, G;
    nbody::Blocks L;
    using Cursor = nbody::BlockCursor;
    struct Source {
        double x, y, z, m0, mh;
    };
    __device__ __forceinline__ Cursor cursor(int jj) const {
        return Cursor(L, jj);
    }
    // source j, or zeros past n
    __device__ __forceinline__ Source at(Cursor& cur, int j, int n) const {
        if (j >= n) return {0.0, 0.0, 0.0, 0.0, 0.0};
        const double* p = qb + nbody::source_at<Blocked>(cur, L, j);
        return {p[0], p[1], p[2], m0[j], mh[j]};
    }
    __device__ __forceinline__ double gm(const Source& s) const {
        return nbody::graded_gm(s.m0, s.mh, f, G);
    }
};

// Geo: one of the launch-a-step path's geometries (with_geometry below,
// f64_force.cuh F64Producer); dist3: the form of d2^1.5 (forces.cuh), a
// template argument, so the dsqrt instantiation is the same code whatever
// the other form costs; Blocked: whether the state may lie in several
// blocks (the mesh).
template <class Geo, int dist3, bool Blocked>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
graded_step_f64_kernel(GradedArgs<double> a, const double* __restrict__ q_in,
                       const double* __restrict__ v_in,
                       double* __restrict__ q_out, double* __restrict__ v_out,
                       int off, int check) {
    __shared__ typename Geo::Smem sm;

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
    const GradedSources<Blocked> sources{qb, a.m0 + mb, a.mh + mb, a.fst[t],
                                         a.G, a.L};
    // tile 0's source first, so that its loads run under the block's set-up
    const bool computes = threadIdx.x < Geo::NC;
    const int jj = threadIdx.x % Geo::TJ;
    auto cur = sources.cursor(jj);
    typename GradedSources<Blocked>::Source s{};
    if (computes) s = sources.at(cur, jj, n);
    nbody::f64_rows_qi<Geo>(qb + own, live, sm);
    if (computes) {
        nbody::f64_rows_terms_rt<Geo, dist3>(sources, cur, s, n, live,
                                             a.eps2, sm);
        return;
    }
    int x;
    const bool folds = nbody::f64_fold_lane<Geo>(live, x);
    const double q0 = folds ? qb[own + x] : 0.0;
    const double v0 = folds ? v_in[sb + own + x] : 0.0;
    const double acc = nbody::f64_rows_fold_tiles<Geo>(n, folds, sm);
    if (folds)
        nbody::graded_euler(acc, q0, v0, a.dt, q_out[ob + x], v_out[ob + x]);
}

__global__ void __launch_bounds__(CHECK_THREADS)
graded_check_f64_kernel(GradedArgs<double> a, double* q, double* v,
                        int off) {
    nbody::graded_check(a, q, v, nbody::graded_step_at(a, off), true);
}

// The largest n whose fused chunk is one resident launch: the crossover
// against the launch-a-step path, B = 5 (PERF.md section 6)
constexpr int RESIDENT_MAX_N = 60;
// a block's threads at most (512: 128 registers a thread, no spills); the
// rows of a cluster at most (the portable cluster size)
constexpr int RES_THREADS = 512, RES_MAX_ROWS = 8;

// The resident chunk at (B, n, D): a cluster of B blocks of `threads`
// threads (a check warp, then the compute threads), G compute threads a
// body in the terms, `bytes` of dynamic shared memory a block; B = 0
// where it does not run
struct ResShape {
    int B, n, D, groups, threads, bytes;
};

// A block's shared memory, in this order
struct ResSmem {
    double* q[2];          // (n, 3) each: the block's row, a ping-pong pair
    double* v[2];
    double* mq[2];         // (n, 3) each, by parity: the P2 row's state,
    double* mv[2];         // which a pending row reads in place of its own
    double* m0;            // (n,) the row's masses
    double* mh;
    double* gm;            // (n,): gm_j of the step
    double* term;          // (n, 3 n): source j's terms of every body
    double* chk[2];        // (B, n, 3) each, by parity: every row's bodies
                           // that the checks read
    double* min_d2;
    long long* arr[2];     // (D,) each, by parity
    long long* hit;
    unsigned char* flag;   // (D,)
};

__host__ __device__ inline long long res_bytes(int B, int n, int D) {
    const long long N = n;
    return 8 * (27 * N + 3 * N * N + 6LL * B * N + 1) + 8 * (2LL * D + 1)
           + D;
}

__device__ inline ResSmem res_carve(unsigned char* base,
                                    const ResShape& sh) {
    const long long n3 = 3LL * sh.n, c3 = sh.B * n3;
    double* d = reinterpret_cast<double*>(base);
    ResSmem s;
    for (int p = 0; p < 2; ++p) {
        s.q[p] = d + p * n3;
        s.v[p] = d + (2 + p) * n3;
        s.mq[p] = d + (4 + p) * n3;
        s.mv[p] = d + (6 + p) * n3;
    }
    s.m0 = d + 8 * n3;
    s.mh = s.m0 + sh.n;
    s.gm = s.mh + sh.n;
    s.term = s.gm + sh.n;
    s.chk[0] = s.term + sh.n * n3;
    s.chk[1] = s.chk[0] + c3;
    s.min_d2 = s.chk[1] + c3;
    long long* l = reinterpret_cast<long long*>(s.min_d2 + 1);
    s.arr[0] = l;
    s.arr[1] = l + sh.D;
    s.hit = l + 2 * sh.D;
    s.flag = reinterpret_cast<unsigned char*>(s.hit + 1);
    return s;
}

// The resident chunk's shape at (B, n, D) on a card whose blocks may have
// smem_max bytes of shared memory: B = 0 (the launch-a-step path) above
// RESIDENT_MAX_N, where the rows are not P123's or more than
// RES_MAX_ROWS, or where a block's carry and terms do not fit
ResShape res_shape(int B, int n, int D, int smem_max) {
    ResShape sh{};
    if (n > RESIDENT_MAX_N || B != 2 + D || B > RES_MAX_ROWS
        || res_bytes(B, n, D) > smem_max)
        return sh;
    const int work = RES_THREADS - 32;   // the compute threads at most
    const int groups = std::max(1, std::min(work / n, n));
    const int compute = std::min(work, (n * groups + 31) / 32 * 32);
    if (compute < 3 * n) return sh;   // a fold lane a compute thread
    sh.B = B;
    sh.n = n;
    sh.D = D;
    sh.groups = groups;
    sh.threads = 32 + compute;
    sh.bytes = static_cast<int>(res_bytes(B, n, D));
    return sh;
}

// Step t's pair terms of the block's row from the state qs (its own, or
// the P2 row's for a pending row): compute thread ct = (group g, body i)
// takes the sources j = g, g + G, ...
template <int dist3>
__device__ __forceinline__ void res_terms(const ResSmem& s,
                                          const ResShape& sh, int ct,
                                          int nct, const double* qs,
                                          double eps2) {
    const int n = sh.n, G = sh.groups, n3 = 3 * n;
    for (int x = ct; x < n * G; x += nct) {
        const int g = x / n, i = x - g * n;
        const double xi = qs[3 * i], yi = qs[3 * i + 1], zi = qs[3 * i + 2];
#pragma unroll 2
        for (int j = g; j < n; j += G) {
            double* tt = s.term + j * n3 + 3 * i;
            nbody::b1_pair_term<dist3, true>(qs[3 * j], qs[3 * j + 1],
                                             qs[3 * j + 2], s.gm[j], xi, yi,
                                             zi, eps2, tt[0], tt[1], tt[2]);
        }
    }
}

// The fused driver's chunk of K steps from *a.s0 as a cluster of B blocks
// (the resident chunk above): block b of scenario row b; the carry from
// (q, v) and a's carries, the result into (q, v) for an even K, (q2, v2)
// for an odd one, and a's carries
template <int dist3>
__global__ void __launch_bounds__(RES_THREADS, 1)
graded_resident_f64_kernel(GradedArgs<double> a, double* q, double* v,
                           double* q2, double* v2, int K, ResShape sh) {
    extern __shared__ __align__(16) unsigned char res_smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const ResSmem s = res_carve(res_smem, sh);
    const int b = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x, T = blockDim.x, n = sh.n, n3 = 3 * n;
    const int s0 = *a.s0, last = s0 + K;
    const long long row = static_cast<long long>(b) * n3;
    // the row's carry, gm_j of the first step, the decision carries
    const double f1 = a.fst[s0 + 1];
    for (int x = tid; x < n3; x += T) {
        s.q[0][x] = q[row + x];
        s.v[0][x] = v[row + x];
    }
    for (int j = tid; j < n; j += T) {
        s.m0[j] = a.m0[b * n + j];
        s.mh[j] = a.mh[b * n + j];
        s.gm[j] = nbody::graded_gm(s.m0[j], s.mh[j], f1, a.G);
    }
    for (int k = tid; k < a.D; k += T) {
        s.arr[0][k] = s.arr[1][k] = a.arr[0][k];
        s.flag[k] = a.flag[k];
    }
    if (tid == 0) {
        *s.hit = *a.hit;
        *s.min_d2 = *a.min_d2;
    }
    // the checks' arguments, their carries this block's own copies: every
    // block makes the same checks on the same bodies, so their carries
    // agree without a collective (the mesh's design)
    GradedArgs<double> c = a;
    c.arr[0] = s.arr[0];
    c.arr[1] = s.arr[1];
    c.hit = s.hit;
    c.flag = s.flag;
    c.min_d2 = s.min_d2;
    // compute thread ct; its fold lane (body, component) ct < 3 n, which
    // sends its component to every block's checks if the checks read the
    // body (the planet, the asteroid, a device); the last n form gm_j
    const int ct = tid - 32, nct = T - 32;
    bool sent = false;
    if (ct >= 0 && ct < n3) {
        sent = ct / 3 == a.planet;
        for (int e = 0; e <= a.D; ++e) sent |= ct / 3 == a.others[e];
    }
    const int yg = nct - 1 - ct;
    __syncthreads();
    cluster.sync();   // every block has started: their shared memory is
                      // there to be written
    for (int k = 1; k <= K; ++k) {
        const int t = s0 + k, in = (k - 1) & 1, par = k & 1;
        // a Problem-3 row pending before the check of step t - 1 reads
        // the P2 row's state of step t - 1, which that block sent
        const bool pend = nbody::graded_source_row(c, b, t, k > 1) != b;
        // while any row is pending the blocks step together; once none
        // is (their arrivals were seen by every block alike), the rows
        // are independent and each block checks its own row
        bool lock = false;
        for (int e = 0; e < a.D; ++e) lock |= s.arr[t & 1][e] == -2;
        if (tid < 32) {
            // the check warp: the checks of step t - 1 on the bodies
            // every block sent, beside the step
            if (k > 1) nbody::graded_check(c, s.chk[in], s.chk[in], t - 1,
                                           false);
        } else {
            const double f_next = k < K && yg < n ? a.fst[t + 1] : 0.0;
            if (ct == 0 && t + 16 <= last) {
                asm volatile("prefetch.global.L1 [%0];" ::"l"(
                    a.fst + t + 16));
                asm volatile("prefetch.global.L1 [%0];" ::"l"(
                    a.md2 + t + 16));
            }
            const double* qs = pend ? s.mq[in] : s.q[in];
            const double* vs = pend ? s.mv[in] : s.v[in];
            res_terms<dist3>(s, sh, ct, nct, qs, a.eps2);
            nbody::f64_bar_sync(1, nct);   // the compute threads' barrier
            if (ct < n3) {
                double acc = 0.0;
                const double* tt = s.term + ct;
#pragma unroll 4
                for (int j = 0; j < n; ++j) acc = __dadd_rn(acc, tt[j * n3]);
                double qo, vo;
                nbody::graded_euler(acc, qs[ct], vs[ct], a.dt, qo, vo);
                s.q[in ^ 1][ct] = qo;
                s.v[in ^ 1][ct] = vo;
                if (sent && !lock) s.chk[par][row + ct] = qo;
                if (sent && lock)
                    for (int r = 0; r < sh.B; ++r)
                        cluster.map_shared_rank(s.chk[par], r)[row + ct] =
                            qo;
                // the P2 row's state to every row pending before the
                // check of t - 1 (those pending before the check of t
                // among them)
                if (b == 1)
                    for (int r = 2; r < sh.B; ++r)
                        if (s.arr[t & 1][r - 2] == -2) {
                            cluster.map_shared_rank(s.mq[par], r)[ct] = qo;
                            cluster.map_shared_rank(s.mv[par], r)[ct] = vo;
                        }
            }
            if (k < K)
                for (int j = yg; j < n; j += nct)
                    s.gm[j] = nbody::graded_gm(s.m0[j], s.mh[j], f_next,
                                               a.G);
        }
        if (lock)
            cluster.sync();   // every row's step t is complete and sent
        else
            __syncthreads();
    }
    // the closing checks of the last step; a row pending before it takes
    // the P2 row's last state, which that block sent
    const int fin = K & 1;
    const bool pend = b >= 2 && s.arr[(last + 1) & 1][b - 2] == -2;
    __syncthreads();
    nbody::graded_check(c, s.chk[fin], s.chk[fin], last, true);
    double* qw = K & 1 ? q2 : q;
    double* vw = K & 1 ? v2 : v;
    for (int x = tid; x < n3; x += T) {
        qw[row + x] = pend ? s.mq[fin][x] : s.q[fin][x];
        vw[row + x] = pend ? s.mv[fin][x] : s.v[fin][x];
    }
    // each carry from the block of the row it reads: P1's min d2, P2's
    // hit and arrivals, a Problem-3 row's flag
    if (tid == 0) {
        if (b == 0) *a.min_d2 = *s.min_d2;
        if (b == 1) *a.hit = *s.hit;
        if (b >= 2) a.flag[b - 2] = s.flag[b - 2];
    }
    if (b == 1)
        for (int k = tid; k < a.D; k += T)
            a.arr[0][k] = a.arr[1][k] = s.arr[0][k];
}

// The shared memory a block of this card may opt into
cudaError_t res_smem_max(int* bytes) {
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(bytes,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The resident chunk's launch configuration at shape sh: one cluster of
// sh.B blocks
struct ResLaunch {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;

    ResLaunch(const ResShape& sh, cudaStream_t stream) : cfg{}, attr{} {
        cfg.gridDim = dim3(sh.B);
        cfg.blockDim = dim3(sh.threads);
        cfg.dynamicSmemBytes = sh.bytes;
        cfg.stream = stream;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = sh.B;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
    }
};

// One launch of the resident chunk at shape sh; adds it to *launched
template <int dist3>
int res_launch(const GradedArgs<double>& a, double* q, double* v,
               double* q2, double* v2, int K, const ResShape& sh,
               cudaStream_t stream, int* launched) {
    const auto kernel = graded_resident_f64_kernel<dist3>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ResLaunch l(sh, stream);
    err = cudaLaunchKernelEx(&l.cfg, kernel, a, q, v, q2, v2, K, sh);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return static_cast<int>(err);
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

// The launch-a-step path's geometries by index (b1_geometry's choice):
// F64Producer<R, RT, TJ, NBUF, MINB>
template <class F>
int with_geometry(int g, F&& f) {
    switch (g) {
        case 0: return f(nbody::F64Producer<4, 1, 64, 4, 3>{});
        case 1: return f(nbody::F64Producer<2, 1, 128, 4, 3>{});
        case 2: return f(nbody::F64Producer<2, 2, 128, 4, 4>{});
        case 3: return f(nbody::F64Producer<4, 2, 64, 4, 4>{});
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// one 64-column tile at most this many sources; the sources up to which
// one row a compute thread beats two in blocks of two rows, and in blocks
// of four
constexpr int NARROW_MAX_N = 64, ONE_ROW_MAX_N = 256, ONE_ROW4_MAX_N = 512;

// Whether B scenario rows of ni rows, in blocks of two rows, take one
// wave at `minb` blocks an SM of a card of `sms` SMs
bool one_wave(int B, int ni, int minb, int sms) {
    return static_cast<long long>(B) * ((ni + 1) / 2)
           <= static_cast<long long>(minb) * sms;
}

// The geometry of a launch of B scenario rows, each its ni rows of n
// bodies, on a card of `sms` SMs: blocks of two rows where they take one
// wave, one row a compute thread (1: 3 blocks an SM, its registers) up to
// ONE_ROW_MAX_N sources, two (2: 4 an SM) above; where they do not,
// blocks of four rows, one row a thread (0) up to ONE_ROW4_MAX_N sources,
// two (3) above; at most NARROW_MAX_N sources, one tile: 0 (PERF.md
// section 6, the table of geometries).
int b1_geometry(int n, int B, int ni, int sms) {
    if (n <= NARROW_MAX_N) return 0;
    if (n <= ONE_ROW_MAX_N) return one_wave(B, ni, 3, sms) ? 1 : 0;
    if (one_wave(B, ni, 4, sms)) return 2;
    return n <= ONE_ROW4_MAX_N ? 0 : 3;
}

// b1_geometry on this card
cudaError_t b1_geometry_here(int n, int B, int ni, int* g) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess) *g = b1_geometry(n, B, ni, sms);
    return err;
}

using StepKernel = void (*)(GradedArgs<double>, const double*, const double*,
                            double*, double*, int, int);

// Geometry Geo's step kernel in the form (dist3, Blocked)
template <class Geo>
StepKernel step_kernel(bool dsqrt, bool blocked) {
    constexpr int DSQRT = nbody::DIST3_DSQRT, SQRT3 = nbody::DIST3_SQRT3;
    return blocked ? (dsqrt ? &graded_step_f64_kernel<Geo, DSQRT, true>
                            : &graded_step_f64_kernel<Geo, SQRT3, true>)
                   : (dsqrt ? &graded_step_f64_kernel<Geo, DSQRT, false>
                            : &graded_step_f64_kernel<Geo, SQRT3, false>);
}

}  // namespace

// Steps s0 + 1 .. s0 + K of a graded driver (mode 0 P12, 1 P3, 2 P123)
// from the state (q, v), (B, n, 3) each, s0 read on the card from the
// device word `s0` (graded.cuh: a CUDA graph of this call serves every
// chunk of K steps); the result lies in (q, v) if K is even, else in (q2,
// v2). arr2 is the second arrival buffer (see graded.cuh), equal to arr on
// entry; the arrivals of step s0 + K lie in both on return. Pointers a
// mode does not use may be null. dist3: 1 dsqrt, 2 sqrt3 (native/core.cc's
// numbers). The fused driver (P123) at n <= RESIDENT_MAX_N, where its
// carry fits a block's shared memory, is one launch of the resident chunk;
// everything else K step launches, in the geometry b1_geometry gives the
// shape, and a check launch. *launched (a host int) is set to the
// launches made. Returns the first launch error, or cudaErrorInvalidValue
// without launching.
extern "C" int graded_chunk_f64_launch(
        double* q, double* v, double* q2, double* v2, const double* m0,
        const double* mh, const double* fst, const double* md2,
        const long long* others, long long* arr, long long* arr2,
        long long* hit, unsigned char* flag, double* min_d2, double* q_snap,
        double* v_snap, int mode, int B, int n, int D, int planet, int dist3,
        double G, double dt, double eps2, double r2, const int* s0, int K,
        int* launched, void* stream) {
    if (!nbody::graded_args_ok(mode, B, n, D, s0, K) || launched == nullptr
        || (dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3))
        return static_cast<int>(cudaErrorInvalidValue);
    *launched = 0;
    const GradedArgs<double> a = nbody::graded_args(
        m0, mh, fst, md2, others, arr, arr2, hit, flag, min_d2, q_snap,
        v_snap, mode, B, n, D, planet, G, dt, eps2, r2, s0);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool dsqrt = dist3 == nbody::DIST3_DSQRT;
    if (mode == nbody::MODE_P123) {
        int smem_max = 0;
        const cudaError_t err = res_smem_max(&smem_max);
        if (err != cudaSuccess) return static_cast<int>(err);
        const ResShape sh = res_shape(B, n, D, smem_max);
        if (sh.B > 0)
            return dsqrt ? res_launch<nbody::DIST3_DSQRT>(a, q, v, q2, v2, K,
                                                          sh, s, launched)
                         : res_launch<nbody::DIST3_SQRT3>(a, q, v, q2, v2, K,
                                                          sh, s, launched);
    }
    int g = 0;
    const cudaError_t err = b1_geometry_here(n, B, n, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return with_geometry(g, [&](auto geo) {
        using Geo = decltype(geo);
        const dim3 grid((n + Geo::R - 1) / Geo::R, B);
        return nbody::graded_chunk(step_kernel<Geo>(dsqrt, false),
                                   graded_check_f64_kernel, grid,
                                   Geo::THREADS, CHECK_THREADS, a, q, v, q2,
                                   v2, K, s, launched);
    });
}

// What the resident chunk is at (B, n, D) on this card: out = {whether it
// runs (1) or the launch-a-step path does (0), blocks (its cluster),
// threads a block, groups, shared memory bytes a block, registers and
// local bytes of the dsqrt kernel, the clusters of that shape the card
// holds at once (0 where it does not run), RESIDENT_MAX_N}. Returns the
// CUDA error, or 0.
extern "C" int graded_resident_f64_info(int B, int n, int D, int* out) {
    const auto kernel = graded_resident_f64_kernel<nbody::DIST3_DSQRT>;
    int smem_max = 0, clusters = 0;
    cudaFuncAttributes attr;
    cudaError_t err = res_smem_max(&smem_max);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    const ResShape sh = res_shape(B, n, D, smem_max);
    if (sh.B > 0) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.bytes);
        ResLaunch l(sh, nullptr);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &l.cfg);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int values[] = {sh.B > 0, sh.B, sh.threads, sh.groups, sh.bytes,
                          attr.numRegs, static_cast<int>(attr.localSizeBytes),
                          clusters, RESIDENT_MAX_N};
    for (int k = 0; k < 9; ++k) out[k] = values[k];
    return 0;
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
    const bool dsqrt = dist3 == nbody::DIST3_DSQRT;
    int g = 0;
    const cudaError_t err = b1_geometry_here(n, B, ni, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return with_geometry(g, [&](auto geo) {
        using Geo = decltype(geo);
        return nbody::graded_rows_launch(
            step_kernel<Geo>(dsqrt, k > 1), graded_check_f64_kernel, Geo::R,
            Geo::THREADS, CHECK_THREADS, a, qv, qv + half, qv_out,
            qv_out ? qv_out + half : nullptr, off, check,
            static_cast<cudaStream_t>(stream));
    });
}

// The geometry of the launch-a-step path at B scenario rows of n bodies,
// ni of them a launch (n on one device, a body rank's block on the mesh):
// out = {its index, rows a block, rows a compute thread, columns a tile,
// term tiles in the ring}. Returns 0, or cudaErrorInvalidValue.
extern "C" int graded_step_f64_geometry(int B, int n, int ni, int* out) {
    if (B < 1 || n < 1 || ni < 1 || ni > n)
        return static_cast<int>(cudaErrorInvalidValue);
    int g = 0;
    const cudaError_t err = b1_geometry_here(n, B, ni, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return with_geometry(g, [&](auto geo) {
        using Geo = decltype(geo);
        const int values[] = {g, Geo::R, Geo::RT, Geo::TJ, Geo::NBUF};
        for (int k = 0; k < 5; ++k) out[k] = values[k];
        return 0;
    });
}

// What the card says of the one-device dsqrt step kernel that B scenario
// rows of n bodies take (forces.cuh kernel_info): out = {registers, local
// bytes, threads, resident blocks an SM, rows a block, columns a tile,
// NBODY_SHARED_RCP, the geometry's index, rows a compute thread, term
// tiles in the ring, shared memory bytes a block}. Returns the CUDA error,
// or 0.
extern "C" int graded_step_f64_info(int B, int n, int* out) {
    if (B < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
    int g = 0;
    const cudaError_t err = b1_geometry_here(n, B, n, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return with_geometry(g, [&](auto geo) {
        using Geo = decltype(geo);
        const int e = nbody::kernel_info(step_kernel<Geo>(true, false),
                                         Geo::THREADS, Geo::R, out);
        if (e != 0) return e;
        const int more[] = {Geo::TJ, NBODY_SHARED_RCP, g, Geo::RT,
                            Geo::NBUF,
                            static_cast<int>(sizeof(typename Geo::Smem))};
        for (int k = 0; k < 6; ++k) out[5 + k] = more[k];
        return 0;
    });
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
