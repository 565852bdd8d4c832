// simulate()'s float32 step on one device: masses, kernel B2's force and
// the update, Euler or leapfrog (KDK), with or without Kahan compensation.
// Up to PERSISTENT_MAX_N bodies a chunk of K steps is one persistent
// launch (sim_step.cuh sim_persistent): every block stays resident, walks
// its row blocks step after step, and waits at a grid barrier between
// steps; above it, where that measured slower, a launch a step of the
// row-range kernel on all n rows. One C call a chunk, which a CUDA graph
// can replay (the launches read the chunk's base step from a device
// word).
//
// Replaces, on simulate's float32 path, nbody_tpu/ops/pallas_forces.py
// ::_accel_kernel together with the per-step work around it that the JAX
// package compiles into one scan per chunk (nbody_tpu/simulate.py
// _chunk_scan, its float32 branch with use_pallas). sim_step.cuh has the
// step's ops, in float32 (every constant rounded to float32 by the
// caller, as ops/integrate.scalar rounds it), the state buffer's slots and
// the chunk's drivers. The force is kernel B2's block force
// (f32_force.cuh b2_rows_force) in the shape B2 takes for one scene of n
// rows (b2_large), so a chunk is bit-equal to the eager loop around kernel
// B2 (and to its plain version, ops/sim_step.sim_chunk_f32_ref) at every n.
//
// A row block is B2's RB rows: each owner thread of a (row, component)
// loads the component's state (and the owner of the row's first component
// its gm inputs of step t + 1), the block sums their force over the
// sources p (leapfrog) or q (Euler) and gm, then each owner updates its
// component and forms what step t + 1 reads of it (the first its gm). The
// grid is min(row blocks, the blocks the card holds at once): at n = 1024
// (B2Small, 16 rows a row block) 64 blocks, at n = 8192 512, one row
// block each; sim_step.cuh has what may go wrong in one launch
// (co-residency, stale reads, the barrier's cost).
//
// The mesh (sim_rows_f32_step, the Blocked form), and one device above
// PERSISTENT_MAX_N on all n rows (B2Tiles): a launch a step on a rank's
// rows [r0, end), summing their force over every row's position in
// the mesh's ordered sum at tile T (f32_force.cuh GroupTiles, bitwise
// parallel/sharded.ring_accel_ordered's; at T = 128, or a T of all n,
// that sum is B2's own and the launch takes B2Tiles: the grouped form's
// staging a tile at a time and its group partials cost time at n = 65536,
// PERF.md) and forming the next step's gm for all n bodies; the host
// gathers the positions between two launches (sim_step.cuh has the
// layout). Replaces, on simulate's float32 mesh path, the JAX package's
// chunk scan inside shard_map (nbody_tpu/simulate.py _chunk_scan_mesh)
// around its ordered ring.
//
// Bound: kernel B2's (fp32 issue, 18 FP32 instructions and one rsqrt a
// pair; at n = 1024 one tile's chain of 128 adds) plus a grid barrier a
// step in one chunk; the update is a few ops a body.

#include <cuda_runtime.h>

#include "f32_force.cuh"
#include "sim_step.cuh"

namespace {

using Args = nbody::SimArgs<float>;
// The largest n whose one-device chunk is one persistent launch; above it
// a launch a step (sim_step_f32_kernel on all n rows), which measured
// faster there on an H100 (PERF.md: 3.24 against 3.50 ms a step at
// n = 65536)
constexpr int PERSISTENT_MAX_N = 8192;

// The block's share of step t in B2's shape Sh: the row block from row
// i0 (from a.r0 on the mesh), from buffer in into buffer out; `next`: form
// what step t + 1 reads (every step but a chunk's last); Blocked: a mesh
// rank's rows, in the ordered sum at a.tile over Tiles (GroupTiles, or
// B2Tiles where that sum is B2's own: at tile 128 or a tile of all n),
// whose launch forms every body's gm apart
template <class Sh, int integ, bool comp, bool Blocked, class Tiles>
__device__ __forceinline__ void step_rows(const Args& a, const float* in,
                                          float* out, long long i0, int t,
                                          int next, typename Sh::Smem& sm) {
    const long long S = a.slot;
    // the rows [r0, end), i0 the row block's first among them
    const int r0 = Blocked ? a.r0 : 0, end = Blocked ? a.end : a.n;
    const float* pos = in + nbody::sim_pos_slot<integ>() * S;
    const float* gm = in + nbody::SLOT_GM * S;
    // k's owned (row, component) (f32_force.cuh B2Shape::OWN): element e
    // of row i, component c, if the thread owns one
    auto owned = [&](int k, long long& i, long long& e, int& c) {
        const int o = threadIdx.x + k * Sh::THREADS;
        c = o / Sh::RB;
        i = r0 + i0 + o % Sh::RB;
        e = 3 * i + c;
        return o < 3 * Sh::RB && i < end;
    };
    // One device's persistent chunk loads each owned component's state
    // and a row's gm inputs of step t + 1 before the force, which hides
    // their latency (on an H100 2.59 to 2.23-2.39 us a step at n = 20,
    // 6.22 to 6.03-6.10 at 1024; PERF.md); the launch-a-step form
    // reads the state after it (read before it and held across the
    // source loop, it made the large shape 17% slower at n = 65536)
    nbody::SimLane<float> s[Sh::OWN];
    float m0[Sh::OWN], mh[Sh::OWN], f = 0.0f;
    if constexpr (!Blocked) {
        if (next) f = a.fst[t + 1];
#pragma unroll
        for (int k = 0; k < Sh::OWN; ++k) {
            long long i, e;
            int c;
            if (owned(k, i, e, c)) {
                s[k] = nbody::sim_load<float, integ, comp>(a, in, e);
                if (next && c == 0) {
                    m0[k] = a.m0[i];
                    mh[k] = a.mh[i];
                }
            }
        }
    }
    float acc[Sh::OWN];
    if constexpr (Blocked)
        nbody::b2_rows_force_tiled<Sh>(
            pos + 3LL * r0, end - r0, i0, pos, gm,
            Tiles::of(a.n, a.tile), a.eps2, sm, acc);
    else
        nbody::b2_rows_force<Sh>(pos, a.n, i0, pos, gm, a.n, a.eps2, sm,
                                 acc);
#pragma unroll
    for (int k = 0; k < Sh::OWN; ++k) {
        long long i, e;
        int c;
        if (owned(k, i, e, c)) {
            if constexpr (Blocked)
                s[k] = nbody::sim_load<float, integ, comp>(a, in, e);
            nbody::sim_update<float, integ, comp>(a, s[k], acc[k], out, e,
                                                  next);
            if (!Blocked && next && c == 0)
                out[nbody::SLOT_GM * S + i] =
                    nbody::graded_gm(m0[k], mh[k], f, a.G);
        }
    }
}

// One device: the K steps of a chunk from st0 in B2's shape Sh, one
// persistent launch
template <class Sh, int integ, bool comp>
__global__ void __launch_bounds__(Sh::THREADS)
sim_chunk_f32_kernel(Args a, float* st0, float* st1, int K) {
    __shared__ typename Sh::Smem sm;
    const int rows = static_cast<int>((a.n + (Sh::RB - 1LL)) / Sh::RB);
    nbody::sim_persistent<float, integ, comp>(
        a, st0, st1, K, rows,
        [&](const float* in, float* out, int rb, int t, int next) {
            step_rows<Sh, integ, comp, false, nbody::B2Tiles>(
                a, in, out, static_cast<long long>(rb) * Sh::RB, t, next,
                sm);
        });
}

// A launch a step: the step at offset `off` in its chunk from buffer in
// into buffer out, in B2's shape Sh and the ordered sum over Tiles, on the
// rows [a.r0, a.end) (a mesh rank's, or all n on one device above
// PERSISTENT_MAX_N)
template <class Sh, int integ, bool comp, class Tiles>
__global__ void __launch_bounds__(Sh::THREADS)
sim_step_f32_kernel(Args a, const float* __restrict__ in,
                    float* __restrict__ out, int off, int next) {
    __shared__ typename Sh::Smem sm;

    const int t = nbody::sim_step_at(a, off);
    if (next) nbody::sim_form_gm_all(a, out, t + 1);
    if (a.end <= a.r0) return;   // a rank without rows
    step_rows<Sh, integ, comp, true, Tiles>(
        a, in, out, static_cast<long long>(blockIdx.x) * Sh::RB, t, next,
        sm);
}

template <class Sh>
int row_blocks(int n) {
    return static_cast<int>((n + (Sh::RB - 1LL)) / Sh::RB);
}

bool persistent(int n) { return n <= PERSISTENT_MAX_N; }

template <class Sh, int integ, bool comp>
int chunk(const Args& a, float* buf[2], int K, int cap, cudaStream_t s,
          int* launched) {
    if (persistent(a.n))
        return nbody::sim_persistent_launch<Sh::THREADS>(
            sim_chunk_f32_kernel<Sh, integ, comp>, row_blocks<Sh>(a.n), cap,
            s, launched, a, buf[0], buf[1], K);
    Args w = nbody::sim_whole(a);
    w.tile = nbody::B2_TJ;   // B2's own sum
    const dim3 grid = nbody::sim_rows_grid(w, Sh::RB);
    return nbody::sim_chunk<float, integ, comp>(
        w, buf, K, s, launched,
        [&](float* in, float* out, int off, int next) {
            sim_step_f32_kernel<Sh, integ, comp, nbody::B2Tiles>
                <<<grid, Sh::THREADS, 0, s>>>(w, in, out, off, next);
        });
}

// A mesh rank's launch: the step at offset `off` from in into out, or
// with out null the chunk's pre-launch on in for that step
template <class Sh, int integ, bool comp>
int rows_step(const Args& a, float* in, float* out, int off, int next,
              cudaStream_t s) {
    if (out == nullptr)
        return nbody::sim_pre<float, integ, comp>(a, in, off, s);
    const dim3 grid = nbody::sim_rows_grid(a, Sh::RB);
    if (a.tile == nbody::B2_TJ || a.tile == a.n)   // B2's own sum
        sim_step_f32_kernel<Sh, integ, comp, nbody::B2Tiles>
            <<<grid, Sh::THREADS, 0, s>>>(a, in, out, off, next);
    else
        sim_step_f32_kernel<Sh, integ, comp, nbody::GroupTiles>
            <<<grid, Sh::THREADS, 0, s>>>(a, in, out, off, next);
    return static_cast<int>(cudaGetLastError());
}

// f(Variant<Sh, integ, comp>{}) for the variant asked for, in B2's shape
// for `rows` rows (b2_large): f reads the variant's template arguments
// from its argument's type
template <class Sh_, int integ, bool comp>
struct Variant {
    using Sh = Sh_;
    static constexpr int INTEG = integ;
    static constexpr bool COMP = comp;
};

template <class Sh, class F>
int on_variant(int integ, bool comp, F&& f) {
    using nbody::SIM_EULER;
    using nbody::SIM_LEAPFROG;
    if (integ == SIM_EULER)
        return comp ? f(Variant<Sh, SIM_EULER, true>{})
                    : f(Variant<Sh, SIM_EULER, false>{});
    return comp ? f(Variant<Sh, SIM_LEAPFROG, true>{})
                : f(Variant<Sh, SIM_LEAPFROG, false>{});
}

template <class F>
int on_variant(int rows, int integ, bool comp, F&& f) {
    return nbody::b2_large(1, rows)
               ? on_variant<nbody::B2Large>(integ, comp, f)
               : on_variant<nbody::B2Small>(integ, comp, f);
}

bool args_ok(int n, int integrator, int compensated) {
    return nbody::sim_args_ok(n, integrator)
           && (compensated == 0 || compensated == 1);
}

}  // namespace

// Steps t0 + 1 .. t0 + K of simulate's float32 loop on one scene of n
// bodies, t0 = *t0w read on the card (a device word). st0, st1: two
// buffers of SIM_SLOTS * n * 3 floats; st0 holds the state in its slots
// q, v (and a for the leapfrog, qc, vc with compensation), and the state
// after step t0 + K lies in the same slots of st0 if K is even, else of
// st1. m0, mh (n,); fst (t0 + K + 1,) at least; G, dt, kick = dt / 2 and
// eps2 each rounded to float32. integrator: 0 Euler, 1 leapfrog. Up to
// PERSISTENT_MAX_N bodies one persistent cooperative launch on min(B2's
// row blocks, the blocks the card holds at once, grid_cap if grid_cap >
// 0) blocks; above it the pre-launch and one launch a step (grid_cap
// unused). *launched (a host int) is set to the launches made. No host
// synchronisation, and nothing the host does depends on t0 (a capture of
// the call serves every chunk of K steps). Returns the first launch error
// (a persistent grid the card cannot hold at once is refused, never run
// another way), or cudaErrorInvalidValue without launching.
extern "C" int sim_chunk_f32_launch(float* st0, float* st1, const float* m0,
                                    const float* mh, const float* fst, int n,
                                    int integrator, int compensated, float G,
                                    float dt, float kick, float eps2,
                                    int grid_cap, const int* t0w, int K,
                                    int* launched, void* stream) {
    if (!args_ok(n, integrator, compensated) || grid_cap < 0
        || !nbody::sim_chunk_args_ok(n, integrator, t0w, K)
        || launched == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    *launched = 0;
    Args a{m0, mh, fst, n, 3LL * n, G, dt, kick, eps2};
    a.t0 = t0w;
    float* buf[2] = {st0, st1};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return on_variant(n, integrator, compensated != 0, [&](auto v) {
        using V = decltype(v);
        return chunk<typename V::Sh, V::INTEG, V::COMP>(a, buf, K, grid_cap,
                                                        s, launched);
    });
}

// One launch of a mesh rank (sim_step.cuh, the row-range form), as
// sim_rows_f64_step (sim_step_f64.cu) has it, in float32, the force's
// ordered sum at tile T >= 1 (a tile above n is one group of n), in B2's
// shape for the rank's rows; the other arguments are
// sim_chunk_f32_launch's.
extern "C" int sim_rows_f32_step(float* in, float* out, const float* m0,
                                 const float* mh, const float* fst, int n,
                                 int ni, int k, int r0, int integrator,
                                 int compensated, int tile, float G,
                                 float dt, float kick, float eps2,
                                 const int* t0w, int off, int next,
                                 void* stream) {
    Args a{m0, mh, fst, n, 3LL * n, G, dt, kick, eps2};
    if (!args_ok(n, integrator, compensated) || tile < 1
        || !nbody::sim_rows_args(a, ni, k, r0, integrator, t0w, off,
                                 out != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    a.tile = tile < n ? tile : n;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool comp = compensated != 0;
    return on_variant(a.end - a.r0, integrator, comp, [&](auto v) {
        using V = decltype(v);
        return rows_step<typename V::Sh, V::INTEG, V::COMP>(a, in, out, off,
                                                            next, s);
    });
}

// What the card says of the persistent chunk kernel of this variant at n
// bodies, in the shape it takes there (sim_step.cuh sim_persistent_info:
// registers, local bytes, threads, resident blocks an SM, rows a row
// block, grid, row blocks).
extern "C" int sim_step_f32_info(int n, int integrator, int compensated,
                                 int* out) {
    if (!args_ok(n, integrator, compensated))
        return static_cast<int>(cudaErrorInvalidValue);
    return on_variant(n, integrator, compensated != 0, [&](auto v) {
        using V = decltype(v);
        using Sh = typename V::Sh;
        return nbody::sim_persistent_info(
            sim_chunk_f32_kernel<Sh, V::INTEG, V::COMP>, Sh::THREADS, Sh::RB,
            row_blocks<Sh>(n), out);
    });
}

// K grid syncs alone, in the grid of the Euler chunk at n bodies (no
// compensation; at most grid_cap blocks if grid_cap > 0): the barrier's
// own cost. Returns the launch error, or cudaErrorInvalidValue.
extern "C" int sim_barrier_f32_launch(int n, int K, int grid_cap,
                                      void* stream) {
    if (n < 1 || K < 1 || grid_cap < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return on_variant(n, nbody::SIM_EULER, false, [&](auto v) {
        using Sh = typename decltype(v)::Sh;
        return nbody::sim_barrier_launch<Sh::THREADS>(
            sim_chunk_f32_kernel<Sh, nbody::SIM_EULER, false>,
            row_blocks<Sh>(n), grid_cap, K, s);
    });
}
