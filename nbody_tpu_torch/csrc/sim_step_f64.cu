// simulate()'s binary64 step on one device: masses, kernel B1's force and
// the update, Euler or leapfrog (KDK), with or without Kahan compensation,
// one launch a step and one C call a chunk, whose launches a CUDA graph
// replays (sim_step.cuh: each launch takes its offset in the chunk and
// reads the chunk's base step from a device word).
//
// Replaces, on simulate's binary64 path, nbody_tpu/ops/pallas_forces_e64.py
// ::_e64_kernel together with the per-step work around it that the JAX
// package compiles into one scan per chunk (nbody_tpu/simulate.py
// _chunk_scan). sim_step.cuh has the step's ops, the state buffer's slots
// and the chunk's launches; here the force is kernel B1's (forces.cuh
// b1_pair_term folded over ascending j), so a chunk is bit-equal to the
// eager loop around kernel B1 (and to its plain version,
// ops/sim_step.sim_chunk_f64_ref).
//
// Launch t's block owns R rows: its force is the binary64 block force
// (f64_force.cuh) over the sources p (leapfrog) or q (Euler) and gm, in
// B1's geometry; its fold lane (row, component) reads its state before the
// fold, then updates its component and forms what step t + 1 reads of it.
//
// The mesh (sim_rows_f64_step, the Blocked instantiation): a launch takes
// a rank's rows [r0, end) and every row's position (sim_step.cuh has the
// layout), and forms the next step's gm for all n bodies; the host
// gathers the positions between two launches. Replaces, on simulate's
// binary64 mesh path, the JAX package's chunk scan inside shard_map
// (nbody_tpu/simulate.py _chunk_scan_mesh).
//
// Bound: kernel B1's (the fp64 pipe, 40 instructions a pair, and the
// fold's latency) plus the launch; the update is a few ops a body.

#include <cuda_runtime.h>

#include "f64_force.cuh"
#include "sim_step.cuh"

namespace {

using Geo = nbody::F64Block;
using Args = nbody::SimArgs<double>;

// The step at offset `off` in its chunk from buffer in into buffer out;
// `next`: form what the step after it reads (every step but a chunk's
// last); Blocked: a mesh rank's rows
template <int dist3, int integ, bool comp, bool Blocked>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
sim_step_f64_kernel(Args a, const double* __restrict__ in,
                    double* __restrict__ out, int off, int next) {
    __shared__ typename Geo::Smem sm;

    if (Blocked && next)
        nbody::sim_form_gm_all(a, out, nbody::sim_step_at(a, off) + 1);
    const long long S = a.slot;
    const int i0 = (Blocked ? a.r0 : 0) + blockIdx.x * Geo::R;
    const int live = min(Geo::R, (Blocked ? a.end : a.n) - i0);
    if (Blocked && live <= 0) return;   // a rank without rows
    const double* pos = in + nbody::sim_pos_slot<integ>() * S;
    nbody::f64_rows_qi<Geo>(pos + 3LL * i0, live, sm);
    if (threadIdx.x < Geo::NC) {
        const nbody::F64Table sources{pos, in + nbody::SLOT_GM * S};
        nbody::f64_rows_terms<Geo, dist3>(sources, a.n, live, a.eps2, sm);
        return;
    }
    int x;
    const bool folds = nbody::f64_fold_lane<Geo>(live, x);
    const long long e = 3LL * i0 + x;
    nbody::SimLane<double> s{};
    if (folds) s = nbody::sim_load<double, integ, comp>(a, in, e);
    const double acc = nbody::f64_rows_fold<Geo>(a.n, folds, sm);
    if (!folds) return;
    nbody::sim_update<double, integ, comp>(a, s, acc, out, e, next);
    if (!Blocked && next && x % 3 == 0)
        nbody::sim_form_gm(a, out, i0 + x / 3,
                           nbody::sim_step_at(a, off) + 1);
}

template <int dist3, int integ, bool comp>
int chunk(const Args& a, double* buf[2], int K, cudaStream_t s) {
    const dim3 grid((a.n + Geo::R - 1) / Geo::R);
    return nbody::sim_chunk<double, integ, comp>(
        a, buf, K, s, [&](double* in, double* out, int off, int next) {
            sim_step_f64_kernel<dist3, integ, comp, false>
                <<<grid, Geo::THREADS, 0, s>>>(a, in, out, off, next);
        });
}

// A mesh rank's launch: the step at offset `off` from in into out, or
// with out null the chunk's pre-launch on in for that step
template <int dist3, int integ, bool comp>
int rows_step(const Args& a, double* in, double* out, int off, int next,
              cudaStream_t s) {
    if (out == nullptr)
        return nbody::sim_pre<double, integ, comp>(a, in, off, s);
    sim_step_f64_kernel<dist3, integ, comp, true>
        <<<nbody::sim_rows_grid(a, Geo::R), Geo::THREADS, 0, s>>>(
            a, in, out, off, next);
    return static_cast<int>(cudaGetLastError());
}

template <int dist3>
int by_variant(int integ, bool comp, const Args& a, double* buf[2], int K,
               cudaStream_t s) {
    using nbody::SIM_EULER;
    using nbody::SIM_LEAPFROG;
    if (integ == SIM_EULER)
        return comp ? chunk<dist3, SIM_EULER, true>(a, buf, K, s)
                    : chunk<dist3, SIM_EULER, false>(a, buf, K, s);
    return comp ? chunk<dist3, SIM_LEAPFROG, true>(a, buf, K, s)
                : chunk<dist3, SIM_LEAPFROG, false>(a, buf, K, s);
}

template <int dist3>
int rows_by_variant(int integ, bool comp, const Args& a, double* in,
                    double* out, int off, int next, cudaStream_t s) {
    using nbody::SIM_EULER;
    using nbody::SIM_LEAPFROG;
    if (integ == SIM_EULER)
        return comp ? rows_step<dist3, SIM_EULER, true>(a, in, out, off,
                                                        next, s)
                    : rows_step<dist3, SIM_EULER, false>(a, in, out, off,
                                                         next, s);
    return comp ? rows_step<dist3, SIM_LEAPFROG, true>(a, in, out, off, next,
                                                       s)
                : rows_step<dist3, SIM_LEAPFROG, false>(a, in, out, off,
                                                        next, s);
}

}  // namespace

// Steps t0 + 1 .. t0 + K of simulate's binary64 loop on one scene of n
// bodies, t0 = *t0w read on the card (a device word). st0, st1: two
// buffers of SIM_SLOTS * n * 3 doubles; st0 holds the state in its slots
// q, v (and a for the leapfrog, qc, vc with compensation), and the state
// after step t0 + K lies in the same slots of st0 if K is even, else of
// st1. m0, mh (n,); fst (t0 + K + 1,) at least. integrator: 0 Euler, 1
// leapfrog; dist3: 1 dsqrt, 2 sqrt3 (native/core.cc's numbers). One launch
// forms the chunk's first inputs, then one launch a step; no host
// synchronisation, and nothing the host does depends on t0, so a capture
// of the call serves every chunk of K steps. Returns the first launch
// error, or cudaErrorInvalidValue without launching.
extern "C" int sim_chunk_f64_launch(double* st0, double* st1,
                                    const double* m0, const double* mh,
                                    const double* fst, int n, int integrator,
                                    int compensated, int dist3, double G,
                                    double dt, double kick, double eps2,
                                    const int* t0w, int K, void* stream) {
    if (!nbody::sim_chunk_args_ok(n, integrator, t0w, K)
        || (compensated != 0 && compensated != 1)
        || (dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3))
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{m0, mh, fst, n, 3LL * n, G, dt, kick, eps2};
    a.t0 = t0w;
    double* buf[2] = {st0, st1};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool comp = compensated != 0;
    return dist3 == nbody::DIST3_DSQRT
               ? by_variant<nbody::DIST3_DSQRT>(integrator, comp, a, buf, K,
                                                s)
               : by_variant<nbody::DIST3_SQRT3>(integrator, comp, a, buf, K,
                                                s);
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
    if ((compensated != 0 && compensated != 1)
        || (dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3)
        || !nbody::sim_rows_args(a, ni, k, r0, integrator, t0w, off,
                                 out != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool comp = compensated != 0;
    return dist3 == nbody::DIST3_DSQRT
               ? rows_by_variant<nbody::DIST3_DSQRT>(integrator, comp, a, in,
                                                     out, off, next, s)
               : rows_by_variant<nbody::DIST3_SQRT3>(integrator, comp, a, in,
                                                     out, off, next, s);
}

// The slots of a state buffer of every step kernel (sim_step.cuh), for
// the wrappers
extern "C" int sim_step_slots() { return nbody::SIM_SLOTS; }
