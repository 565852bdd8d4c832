// simulate()'s float32 step on one device: masses, kernel B2's force and
// the update, Euler or leapfrog (KDK), with or without Kahan compensation,
// one launch a step and one C call a chunk, whose launches a CUDA graph
// replays (sim_step.cuh: each launch takes its offset in the chunk and
// reads the chunk's base step from a device word).
//
// Replaces, on simulate's float32 path, nbody_tpu/ops/pallas_forces.py
// ::_accel_kernel together with the per-step work around it that the JAX
// package compiles into one scan per chunk (nbody_tpu/simulate.py
// _chunk_scan, its float32 branch with use_pallas). sim_step.cuh has the
// step's ops, in float32 (every constant rounded to float32 by the
// caller, as ops/integrate.scalar rounds it), the state buffer's slots and
// the chunk's launches. The force is kernel B2's block force
// (f32_force.cuh b2_rows_force) in the shape B2 takes for one scene of n
// rows (b2_large), so a chunk is bit-equal to the eager loop around kernel
// B2 (and to its plain version, ops/sim_step.sim_chunk_f32_ref) at every n.
//
// Launch t's block owns B2's RB rows: it sums their force over the sources
// p (leapfrog) or q (Euler) and gm; then each owner thread of a (row,
// component) reads the component's state, updates it and forms what step
// t + 1 reads of it (the owner of the row's first component its gm).
//
// The mesh (sim_rows_f32_step, the Blocked instantiation): a launch takes
// a rank's rows [r0, end), sums their force over every row's position in
// the mesh's ordered sum at tile T (f32_force.cuh GroupTiles, bitwise
// parallel/sharded.ring_accel_ordered's; at T = 128, or a T of all n,
// that sum is B2's own and the launch takes B2Tiles: the grouped form's
// staging a tile at a time and its group partials cost time at n = 65536,
// PERF.md) and forms the next step's gm for all n bodies; the host
// gathers the positions between two launches (sim_step.cuh has the
// layout). Replaces, on
// simulate's float32 mesh path, the JAX package's chunk scan inside
// shard_map (nbody_tpu/simulate.py _chunk_scan_mesh) around its ordered
// ring.
//
// Bound: kernel B2's (fp32 issue, 18 FP32 instructions and one rsqrt a
// pair; at n = 1024 the launch and one tile's chain of 128 adds) plus the
// launch; the update is a few ops a body.

#include <cuda_runtime.h>

#include "f32_force.cuh"
#include "sim_step.cuh"

namespace {

using Args = nbody::SimArgs<float>;

// The step at offset `off` in its chunk from buffer in into buffer out in
// B2's shape Sh; `next`: form what the step after it reads (every step but
// a chunk's last); Blocked: a mesh
// rank's rows, in the ordered sum at a.tile over Tiles (GroupTiles, or
// B2Tiles where that sum is B2's own: at tile 128 or a tile of all n)
template <class Sh, int integ, bool comp, bool Blocked,
          class Tiles = nbody::B2Tiles>
__global__ void __launch_bounds__(Sh::THREADS)
sim_step_f32_kernel(Args a, const float* __restrict__ in,
                    float* __restrict__ out, int off, int next) {
    __shared__ typename Sh::Smem sm;

    if (Blocked && next)
        nbody::sim_form_gm_all(a, out, nbody::sim_step_at(a, off) + 1);
    const long long S = a.slot;
    // the rows [r0, end), i0 the block's first among them
    const int r0 = Blocked ? a.r0 : 0, end = Blocked ? a.end : a.n;
    if (Blocked && end <= r0) return;   // a rank without rows
    const long long i0 = static_cast<long long>(blockIdx.x) * Sh::RB;
    const float* pos = in + nbody::sim_pos_slot<integ>() * S;
    const float* gm = in + nbody::SLOT_GM * S;
    float acc[Sh::OWN];
    if constexpr (Blocked)
        nbody::b2_rows_force_tiled<Sh>(
            pos + 3LL * r0, end - r0, i0, pos, gm,
            Tiles::of(a.n, a.tile), a.eps2, sm, acc);
    else
        nbody::b2_rows_force<Sh>(pos, a.n, i0, pos, gm, a.n, a.eps2, sm,
                                 acc);
    // the owned (row, component)s (f32_force.cuh B2Shape::OWN): their
    // state read after the force (read before it and held across the
    // source loop, it made the large shape 17% slower at n = 65536), then
    // updated
#pragma unroll
    for (int k = 0; k < Sh::OWN; ++k) {
        const int o = threadIdx.x + k * Sh::THREADS, c = o / Sh::RB;
        const long long i = r0 + i0 + o % Sh::RB, e = 3 * i + c;
        if (o < 3 * Sh::RB && i < end) {
            nbody::sim_update<float, integ, comp>(
                a, nbody::sim_load<float, integ, comp>(a, in, e), acc[k],
                out, e, next);
            if (!Blocked && next && c == 0)
                nbody::sim_form_gm(a, out, i, nbody::sim_step_at(a, off) + 1);
        }
    }
}

template <class Sh, int integ, bool comp>
int chunk(const Args& a, float* buf[2], int K, cudaStream_t s) {
    const dim3 grid(static_cast<unsigned>((a.n + (Sh::RB - 1LL)) / Sh::RB));
    return nbody::sim_chunk<float, integ, comp>(
        a, buf, K, s, [&](float* in, float* out, int off, int next) {
            sim_step_f32_kernel<Sh, integ, comp, false>
                <<<grid, Sh::THREADS, 0, s>>>(a, in, out, off, next);
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
        sim_step_f32_kernel<Sh, integ, comp, true, nbody::B2Tiles>
            <<<grid, Sh::THREADS, 0, s>>>(a, in, out, off, next);
    else
        sim_step_f32_kernel<Sh, integ, comp, true, nbody::GroupTiles>
            <<<grid, Sh::THREADS, 0, s>>>(a, in, out, off, next);
    return static_cast<int>(cudaGetLastError());
}

template <class Sh>
int rows_by_variant(int integ, bool comp, const Args& a, float* in,
                    float* out, int off, int next, cudaStream_t s) {
    using nbody::SIM_EULER;
    using nbody::SIM_LEAPFROG;
    if (integ == SIM_EULER)
        return comp ? rows_step<Sh, SIM_EULER, true>(a, in, out, off, next,
                                                     s)
                    : rows_step<Sh, SIM_EULER, false>(a, in, out, off, next,
                                                      s);
    return comp ? rows_step<Sh, SIM_LEAPFROG, true>(a, in, out, off, next, s)
                : rows_step<Sh, SIM_LEAPFROG, false>(a, in, out, off, next,
                                                     s);
}

template <class Sh>
int by_variant(int integ, bool comp, const Args& a, float* buf[2], int K,
               cudaStream_t s) {
    using nbody::SIM_EULER;
    using nbody::SIM_LEAPFROG;
    if (integ == SIM_EULER)
        return comp ? chunk<Sh, SIM_EULER, true>(a, buf, K, s)
                    : chunk<Sh, SIM_EULER, false>(a, buf, K, s);
    return comp ? chunk<Sh, SIM_LEAPFROG, true>(a, buf, K, s)
                : chunk<Sh, SIM_LEAPFROG, false>(a, buf, K, s);
}

template <class Sh>
int info(int integ, bool comp, int* out) {
    using nbody::SIM_EULER;
    using nbody::SIM_LEAPFROG;
    auto of = [&](auto kernel) {
        return nbody::kernel_info(kernel, Sh::THREADS, Sh::RB, out);
    };
    if (integ == SIM_EULER)
        return comp ? of(sim_step_f32_kernel<Sh, SIM_EULER, true, false>)
                    : of(sim_step_f32_kernel<Sh, SIM_EULER, false, false>);
    return comp ? of(sim_step_f32_kernel<Sh, SIM_LEAPFROG, true, false>)
                : of(sim_step_f32_kernel<Sh, SIM_LEAPFROG, false, false>);
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
// eps2 each rounded to float32. integrator: 0 Euler, 1 leapfrog. One
// launch forms the chunk's first inputs, then one launch a step; no host
// synchronisation, and nothing the host does depends on t0 (a capture of
// the call serves every chunk of K steps). Returns the first launch
// error, or cudaErrorInvalidValue without launching.
extern "C" int sim_chunk_f32_launch(float* st0, float* st1, const float* m0,
                                    const float* mh, const float* fst, int n,
                                    int integrator, int compensated, float G,
                                    float dt, float kick, float eps2,
                                    const int* t0w, int K, void* stream) {
    if (!args_ok(n, integrator, compensated)
        || !nbody::sim_chunk_args_ok(n, integrator, t0w, K))
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{m0, mh, fst, n, 3LL * n, G, dt, kick, eps2};
    a.t0 = t0w;
    float* buf[2] = {st0, st1};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool comp = compensated != 0;
    return nbody::b2_large(1, n)
               ? by_variant<nbody::B2Large>(integrator, comp, a, buf, K, s)
               : by_variant<nbody::B2Small>(integrator, comp, a, buf, K, s);
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
    return nbody::b2_large(1, a.end - a.r0)
               ? rows_by_variant<nbody::B2Large>(integrator, comp, a, in,
                                                 out, off, next, s)
               : rows_by_variant<nbody::B2Small>(integrator, comp, a, in,
                                                 out, off, next, s);
}

// What the card says of the step kernel of this variant at n bodies, in
// the shape it takes there (forces.cuh kernel_info).
extern "C" int sim_step_f32_info(int n, int integrator, int compensated,
                                 int* out) {
    if (!args_ok(n, integrator, compensated))
        return static_cast<int>(cudaErrorInvalidValue);
    return nbody::b2_large(1, n)
               ? info<nbody::B2Large>(integrator, compensated != 0, out)
               : info<nbody::B2Small>(integrator, compensated != 0, out);
}
