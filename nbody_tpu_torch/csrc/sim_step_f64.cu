// simulate()'s binary64 step on one device: masses, kernel B1's force and
// the update, Euler or leapfrog (KDK), with or without Kahan compensation.
// Up to PERSISTENT_MAX_N bodies a chunk of K steps is one persistent
// launch (sim_step.cuh sim_persistent): every block stays resident, walks
// its row blocks step after step, and waits at a grid barrier between
// steps; above it, where that measured slower, a launch a step of the
// row-range kernel on all n rows (the Blocked form). One C call a chunk,
// which a CUDA graph can replay (the launches read the chunk's base step
// from a device word).
//
// Replaces, on simulate's binary64 path, nbody_tpu/ops/pallas_forces_e64.py
// ::_e64_kernel together with the per-step work around it that the JAX
// package compiles into one scan per chunk (nbody_tpu/simulate.py
// _chunk_scan). sim_step.cuh has the step's ops, the state buffer's slots
// and the chunk's drivers; here the force is kernel B1's (forces.cuh
// b1_pair_term folded over ascending j), so a chunk is bit-equal to the
// eager loop around kernel B1 (and to its plain version,
// ops/sim_step.sim_chunk_f64_ref).
//
// The persistent chunk: a row block is R rows (B1's geometry, F64Block):
// its force is the binary64 block force (f64_force.cuh) over the sources
// p (leapfrog) or q (Euler) and gm, each compute thread's source loaded a
// tile ahead (f64_rows_terms_ahead: plain loads, the chunk writes them);
// its fold lane (row, component) reads its state and forms its row's gm
// of step t + 1 before the fold, then updates its component and forms
// the rest of what step t + 1 reads of it. The block's compute threads
// leave the step once their terms are written and its idle fold lanes
// once the fold is done; every thread then meets the others at the
// __syncthreads between row blocks and at the grid barrier (sim_step.cuh
// has what may go wrong in one launch: co-residency, stale reads, the
// barrier's cost). The grid is min(n / R row blocks, the blocks the card
// holds at once): at n = 512, 128 blocks of one row block each.
//
// The Blocked form, one device above PERSISTENT_MAX_N on all n rows and
// the mesh (sim_rows_f64_step): a launch a step on the rows [r0, end),
// reading every row's position (sim_step.cuh has the layout), forming the
// next step's gm for all n bodies; the host gathers the positions between
// two launches (an NCCL call cannot sit inside a kernel). Replaces, on
// simulate's binary64 mesh path, the JAX package's chunk scan inside
// shard_map (nbody_tpu/simulate.py _chunk_scan_mesh). Its block force is
// B1''s (graded_step_f64.cu): the compute threads are F64Producer's (RT
// rows a thread against each source, the source loaded a tile ahead
// through SimSources, zero numerators without __ddiv_rn's slow-path
// call), the fold warp's tile is unrolled (f64_rows_fold_tiles), the same
// sums in the same order. Its geometry is chosen by the launch's rows
// (sim_geometry): blocks of 4 rows where few rows would leave SMs idle,
// blocks of 8 where the rows fill the card, as at n = 65536: their fold
// lanes (3 a row) and 4 blocks an SM give the fold enough independent
// chains of adds to keep up with the producer.
//
// Bound: kernel B1's (the fp64 pipe, 40 instructions a pair, and the
// fold's latency: n dependent adds a row component, about 9.5 cycles each,
// run side by side over the fold lanes an SM holds) plus, in the
// persistent chunk, a grid barrier a step; the update is a few ops a
// body. On an "NVIDIA H100 80GB HBM3, 700.00 W" at n = 65536 (PERF.md
// section 6): with kernel B1's producer and fold loop (F64Block) the
// Blocked step took 24.86 ms, 19.98 with no fold adds and 17.74 with no
// terms past the ring; in the wide geometry below 19.78 ms, bound by the
// producer (17.93 ms with no fold adds, about 57% of the fp64 pipe).

#include <cuda_runtime.h>

#include "f64_force.cuh"
#include "sim_step.cuh"

namespace {

using Geo = nbody::F64Block;
using Args = nbody::SimArgs<double>;
// The largest n whose one-device chunk is one persistent launch; above it
// a launch a step (sim_step_f64_kernel on all n rows), which measured
// faster there on an H100 (PERF.md: 12.63 against 12.89 us a step at
// n = 1024, 30.6 against 53.9 at 2048; with the narrow F64Producer
// geometry it is faster from 256 bodies on, PERF.md section 7, an open
// question without a benchmark cell)
constexpr int PERSISTENT_MAX_N = 512;

// The persistent chunk's share of step t: the live rows from i0, from
// buffer in into buffer out; `next`: form what step t + 1 reads (every
// step but a chunk's last). Its loads that wait for nothing of this step
// are issued early: a compute thread's first source before the rows'
// barrier and each next one a tile ahead (f64_rows_terms_ahead), a fold
// lane's gm of step t + 1 before the fold (out's gm slot is read only in
// the next step).
template <int dist3, int integ, bool comp>
__device__ __forceinline__ void step_rows(const Args& a, const double* in,
                                          double* out, int i0, int live,
                                          int t, int next,
                                          typename Geo::Smem& sm) {
    const long long S = a.slot;
    const double* pos = in + nbody::sim_pos_slot<integ>() * S;
    const double* gm = in + nbody::SLOT_GM * S;
    const bool computes = threadIdx.x < Geo::NC;
    nbody::F64Src first{};
    if (computes)
        first = nbody::F64Src::at(pos, gm, threadIdx.x % Geo::TJ, a.n);
    nbody::f64_rows_qi<Geo>(pos + 3LL * i0, live, sm);
    if (computes) {
        nbody::f64_rows_terms_ahead<Geo, dist3>(pos, gm, a.n, live, a.eps2,
                                                sm, first);
        return;
    }
    int x;
    const bool folds = nbody::f64_fold_lane<Geo>(live, x);
    const long long e = 3LL * i0 + x;
    nbody::SimLane<double> s{};
    if (folds) s = nbody::sim_load<double, integ, comp>(a, in, e);
    if (next && folds && x % 3 == 0)
        nbody::sim_form_gm(a, out, i0 + x / 3, t + 1);
    const double acc = nbody::f64_rows_fold<Geo>(a.n, folds, sm);
    if (!folds) return;
    nbody::sim_update<double, integ, comp>(a, s, acc, out, e, next);
}

// One device: the K steps of a chunk from st0, one persistent launch
template <int dist3, int integ, bool comp>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
sim_chunk_f64_kernel(Args a, double* st0, double* st1, int K) {
    __shared__ typename Geo::Smem sm;
    const int rows = (a.n + Geo::R - 1) / Geo::R;
    nbody::sim_persistent<double, integ, comp>(
        a, st0, st1, K, rows,
        [&](const double* in, double* out, int rb, int t, int next) {
            const int i0 = rb * Geo::R;
            step_rows<dist3, integ, comp>(a, in, out, i0,
                                          min(Geo::R, a.n - i0), t, next,
                                          sm);
        });
}

// The Blocked step's sources (f64_force.cuh f64_rows_terms_rt): the
// positions its force reads (q, or the leapfrog's p) and gm, slots of the
// launch's buffer `in`, which no thread of the launch writes (`next`
// writes out's), so the loads may take the read-only path; source j a
// position and its gm_j, formed by the launch before
struct SimSources {
    const double* __restrict__ q;     // (n, 3)
    const double* __restrict__ gmj;   // (n,)
    struct Cursor {};
    struct Source {
        double x, y, z, gm;
    };
    __device__ __forceinline__ Cursor cursor(int) const { return {}; }
    // source j, or zeros past n
    __device__ __forceinline__ Source at(Cursor&, int j, int n) const {
        if (j >= n) return {0.0, 0.0, 0.0, 0.0};
        return {q[3LL * j], q[3LL * j + 1], q[3LL * j + 2], gmj[j]};
    }
    __device__ __forceinline__ double gm(const Source& s) const {
        return s.gm;
    }
};

// A launch a step in geometry G (with_geometry below, f64_force.cuh
// F64Producer): the step at offset `off` in its chunk from buffer in into
// buffer out, on the rows [a.r0, a.end) (a mesh rank's, or all n on one
// device above PERSISTENT_MAX_N); the block's R rows from r0 +
// blockIdx.x * R. Tile 0's source is loaded before the rows' barrier, so
// that its latency runs under it; a fold lane reads its state before the
// fold.
template <class G, int dist3, int integ, bool comp>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
sim_step_f64_kernel(Args a, const double* __restrict__ in,
                    double* __restrict__ out, int off, int next) {
    __shared__ typename G::Smem sm;

    const int t = nbody::sim_step_at(a, off);
    if (next) nbody::sim_form_gm_all(a, out, t + 1);
    const int i0 = a.r0 + blockIdx.x * G::R;
    const int live = min(G::R, a.end - i0);
    if (live <= 0) return;   // a rank without rows
    const long long S = a.slot;
    const SimSources src{in + nbody::sim_pos_slot<integ>() * S,
                         in + nbody::SLOT_GM * S};
    const bool computes = threadIdx.x < G::NC;
    SimSources::Cursor cur = src.cursor(threadIdx.x % G::TJ);
    SimSources::Source s{};
    if (computes) s = src.at(cur, threadIdx.x % G::TJ, a.n);
    nbody::f64_rows_qi<G>(src.q + 3LL * i0, live, sm);
    if (computes) {
        nbody::f64_rows_terms_rt<G, dist3>(src, cur, s, a.n, live, a.eps2,
                                           sm);
        return;
    }
    int x;
    const bool folds = nbody::f64_fold_lane<G>(live, x);
    const long long e = 3LL * i0 + x;
    nbody::SimLane<double> st{};
    if (folds) st = nbody::sim_load<double, integ, comp>(a, in, e);
    const double acc = nbody::f64_rows_fold_tiles<G>(a.n, folds, sm);
    if (!folds) return;
    nbody::sim_update<double, integ, comp>(a, st, acc, out, e, next);
}

// The Blocked step's geometries by index (sim_geometry's choice):
// F64Producer<R, RT, TJ, NBUF, MINB>. Of the sweep's 30 (PERF.md section
// 6) the fastest at 513 to 2048 rows and at 4096 to 65536 rows.
template <class F>
int with_geometry(int g, F&& f) {
    switch (g) {
        case 0: return f(nbody::F64Producer<4, 2, 64, 4, 4>{});
        case 1: return f(nbody::F64Producer<8, 2, 32, 4, 4>{});
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The blocks an SM of the wide geometry above which it is chosen
constexpr int WIDE_MIN_BLOCKS_PER_SM = 2;

// The Blocked step's geometry for a launch of `rows` rows on a card of
// `sms` SMs: the wide one (1: blocks of 8 rows, 24 fold lanes) where its
// blocks outnumber WIDE_MIN_BLOCKS_PER_SM an SM, else blocks of four
// rows (0), twice as many blocks, which keep more SMs busy (on an H100,
// 2048 rows 0.0259 ms a step against 0.0297, 2560 rows 0.0465 against
// 0.0443; PERF.md section 6).
int sim_geometry(int rows, int sms) {
    return (rows + 7) / 8 > WIDE_MIN_BLOCKS_PER_SM * sms ? 1 : 0;
}

// sim_geometry on this card
cudaError_t sim_geometry_here(int rows, int* g) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess) *g = sim_geometry(rows, sms);
    return err;
}

// f(step) in the geometry sim_geometry gives a's rows, step(in, out, off,
// next) launching the Blocked step at offset `off` from in into out
template <int dist3, int integ, bool comp, class F>
int with_blocked_step(const Args& a, cudaStream_t s, F&& f) {
    int g = 0;
    const cudaError_t err = sim_geometry_here(a.end - a.r0, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return with_geometry(g, [&](auto geo) {
        using G = decltype(geo);
        const dim3 grid = nbody::sim_rows_grid(a, G::R);
        return f([&](const double* in, double* out, int off, int next) {
            sim_step_f64_kernel<G, dist3, integ, comp>
                <<<grid, G::THREADS, 0, s>>>(a, in, out, off, next);
        });
    });
}

int row_blocks(int n) { return (n + Geo::R - 1) / Geo::R; }

bool persistent(int n) { return n <= PERSISTENT_MAX_N; }

template <int dist3, int integ, bool comp>
int chunk(const Args& a, double* buf[2], int K, int cap, cudaStream_t s,
          int* launched) {
    if (persistent(a.n))
        return nbody::sim_persistent_launch<Geo::THREADS>(
            sim_chunk_f64_kernel<dist3, integ, comp>, row_blocks(a.n), cap,
            s, launched, a, buf[0], buf[1], K);
    const Args w = nbody::sim_whole(a);
    return with_blocked_step<dist3, integ, comp>(w, s, [&](auto step) {
        return nbody::sim_chunk<double, integ, comp>(w, buf, K, s, launched,
                                                     step);
    });
}

// A mesh rank's launch: the step at offset `off` from in into out, or
// with out null the chunk's pre-launch on in for that step
template <int dist3, int integ, bool comp>
int rows_step(const Args& a, double* in, double* out, int off, int next,
              cudaStream_t s) {
    if (out == nullptr)
        return nbody::sim_pre<double, integ, comp>(a, in, off, s);
    return with_blocked_step<dist3, integ, comp>(a, s, [&](auto step) {
        step(in, out, off, next);
        return static_cast<int>(cudaGetLastError());
    });
}

// f(Variant<dist3, integ, comp>{}) for the variant asked for: f reads the
// variant's template arguments from its argument's type
template <int dist3, int integ, bool comp>
struct Variant {
    static constexpr int D3 = dist3, INTEG = integ;
    static constexpr bool COMP = comp;
};

template <int dist3, class F>
int on_variant(int integ, bool comp, F&& f) {
    using nbody::SIM_EULER;
    using nbody::SIM_LEAPFROG;
    if (integ == SIM_EULER)
        return comp ? f(Variant<dist3, SIM_EULER, true>{})
                    : f(Variant<dist3, SIM_EULER, false>{});
    return comp ? f(Variant<dist3, SIM_LEAPFROG, true>{})
                : f(Variant<dist3, SIM_LEAPFROG, false>{});
}

template <class F>
int on_variant(int dist3, int integ, bool comp, F&& f) {
    return dist3 == nbody::DIST3_DSQRT
               ? on_variant<nbody::DIST3_DSQRT>(integ, comp, f)
               : on_variant<nbody::DIST3_SQRT3>(integ, comp, f);
}

bool args_ok(int n, int integrator, int compensated, int dist3) {
    return nbody::sim_args_ok(n, integrator)
           && (compensated == 0 || compensated == 1)
           && (dist3 == nbody::DIST3_DSQRT || dist3 == nbody::DIST3_SQRT3);
}

}  // namespace

// Steps t0 + 1 .. t0 + K of simulate's binary64 loop on one scene of n
// bodies, t0 = *t0w read on the card (a device word). st0, st1: two
// buffers of SIM_SLOTS * n * 3 doubles; st0 holds the state in its slots
// q, v (and a for the leapfrog, qc, vc with compensation), and the state
// after step t0 + K lies in the same slots of st0 if K is even, else of
// st1. m0, mh (n,); fst (t0 + K + 1,) at least. integrator: 0 Euler, 1
// leapfrog; dist3: 1 dsqrt, 2 sqrt3 (native/core.cc's numbers). Up to
// PERSISTENT_MAX_N bodies one persistent cooperative launch on min(n / 4
// row blocks, the blocks the card holds at once, grid_cap if grid_cap >
// 0) blocks; above it the pre-launch and one launch a step (grid_cap
// unused). *launched (a host int) is set to the launches made. No host
// synchronisation, and nothing the host does depends on t0, so a capture
// of the call serves every chunk of K steps. Returns the first launch
// error (a persistent grid the card cannot hold at once is refused, never
// run another way), or cudaErrorInvalidValue without launching.
extern "C" int sim_chunk_f64_launch(double* st0, double* st1,
                                    const double* m0, const double* mh,
                                    const double* fst, int n, int integrator,
                                    int compensated, int dist3, double G,
                                    double dt, double kick, double eps2,
                                    int grid_cap, const int* t0w, int K,
                                    int* launched, void* stream) {
    if (!args_ok(n, integrator, compensated, dist3) || grid_cap < 0
        || !nbody::sim_chunk_args_ok(n, integrator, t0w, K)
        || launched == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    *launched = 0;
    Args a{m0, mh, fst, n, 3LL * n, G, dt, kick, eps2};
    a.t0 = t0w;
    double* buf[2] = {st0, st1};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return on_variant(dist3, integrator, compensated != 0,
                      [&](auto v) {
                          using V = decltype(v);
                          return chunk<V::D3, V::INTEG, V::COMP>(
                              a, buf, K, grid_cap, s, launched);
                      });
}

// One launch of a mesh rank (sim_step.cuh, the row-range form): step
// t = *t0w + off (off >= 1, t0w a device word) of the rows [r0, r0 + ni)
// of n bodies in k blocks of ni = ceil(n / k) rows, from buffer in into
// buffer out, each SIM_SLOTS * k * ni * 3 doubles (slot s holds row i at
// s * k * ni * 3 + 3 * i), reading every row's position (q, or p for the
// leapfrog) and gm from in; `next`: form what step t + 1 reads, its gm for
// all n bodies. With out null, the chunk's pre-launch: what step t reads,
// formed in buffer in from its whole state. The other arguments are
// sim_chunk_f64_launch's. Returns the launch error, or
// cudaErrorInvalidValue without launching.
extern "C" int sim_rows_f64_step(double* in, double* out, const double* m0,
                                 const double* mh, const double* fst, int n,
                                 int ni, int k, int r0, int integrator,
                                 int compensated, int dist3, double G,
                                 double dt, double kick, double eps2,
                                 const int* t0w, int off, int next,
                                 void* stream) {
    Args a{m0, mh, fst, n, 3LL * n, G, dt, kick, eps2};
    if (!args_ok(n, integrator, compensated, dist3)
        || !nbody::sim_rows_args(a, ni, k, r0, integrator, t0w, off,
                                 out != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return on_variant(dist3, integrator, compensated != 0,
                      [&](auto v) {
                          using V = decltype(v);
                          return rows_step<V::D3, V::INTEG, V::COMP>(
                              a, in, out, off, next, s);
                      });
}

// What the card says of the persistent chunk kernel of this variant at n
// bodies (sim_step.cuh sim_persistent_info: registers, local bytes,
// threads, resident blocks an SM, rows a row block, grid, row blocks).
extern "C" int sim_step_f64_info(int n, int integrator, int compensated,
                                 int dist3, int* out) {
    if (!args_ok(n, integrator, compensated, dist3))
        return static_cast<int>(cudaErrorInvalidValue);
    return on_variant(dist3, integrator, compensated != 0,
                      [&](auto v) {
                          using V = decltype(v);
                          return nbody::sim_persistent_info(
                              sim_chunk_f64_kernel<V::D3, V::INTEG, V::COMP>,
                              Geo::THREADS, Geo::R, row_blocks(n), out);
                      });
}

// The Blocked step's geometry for a launch of `rows` rows of n bodies (n
// on one device above PERSISTENT_MAX_N, a rank's rows on the mesh): out =
// {its index, rows a block, rows a compute thread, columns a tile, term
// tiles in the ring}. Returns 0, or the CUDA error
// (cudaErrorInvalidValue for rows outside 0 .. n).
extern "C" int sim_step_f64_geometry(int n, int rows, int* out) {
    if (n < 1 || rows < 0 || rows > n)
        return static_cast<int>(cudaErrorInvalidValue);
    int g = 0;
    const cudaError_t err = sim_geometry_here(rows, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return with_geometry(g, [&](auto geo) {
        using G = decltype(geo);
        const int values[] = {g, G::R, G::RT, G::TJ, G::NBUF};
        for (int k = 0; k < 5; ++k) out[k] = values[k];
        return 0;
    });
}

// What the card says of the Blocked step kernel of this variant that a
// launch of `rows` rows of n bodies takes (forces.cuh kernel_info): out =
// {registers, local bytes, threads, resident blocks an SM, rows a block,
// columns a tile, the geometry's index, rows a compute thread, term tiles
// in the ring, shared memory bytes a block}. Returns the CUDA error, or
// 0.
extern "C" int sim_step_f64_blocked_info(int n, int rows, int integrator,
                                         int compensated, int dist3,
                                         int* out) {
    if (!args_ok(n, integrator, compensated, dist3) || rows < 0 || rows > n)
        return static_cast<int>(cudaErrorInvalidValue);
    int g = 0;
    const cudaError_t err = sim_geometry_here(rows, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
    return on_variant(dist3, integrator, compensated != 0, [&](auto v) {
        using V = decltype(v);
        return with_geometry(g, [&](auto geo) {
            using G = decltype(geo);
            const int e = nbody::kernel_info(
                sim_step_f64_kernel<G, V::D3, V::INTEG, V::COMP>,
                G::THREADS, G::R, out);
            if (e != 0) return e;
            const int more[] = {G::TJ, g, G::RT, G::NBUF,
                                static_cast<int>(sizeof(typename G::Smem))};
            for (int k = 0; k < 5; ++k) out[5 + k] = more[k];
            return 0;
        });
    });
}

// K grid syncs alone, in the grid of the Euler chunk at n bodies (dsqrt,
// no compensation; at most grid_cap blocks if grid_cap > 0): the
// barrier's own cost. Returns the launch error, or cudaErrorInvalidValue.
extern "C" int sim_barrier_f64_launch(int n, int K, int grid_cap,
                                      void* stream) {
    if (n < 1 || K < 1 || grid_cap < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return nbody::sim_barrier_launch<Geo::THREADS>(
        sim_chunk_f64_kernel<nbody::DIST3_DSQRT, nbody::SIM_EULER, false>,
        row_blocks(n), grid_cap, K, static_cast<cudaStream_t>(stream));
}

// The slots of a state buffer of every step kernel (sim_step.cuh), for
// the wrappers
extern "C" int sim_step_slots() { return nbody::SIM_SLOTS; }
