// simulate()'s binary64 step on one device: masses, kernel B1's force and
// the update, Euler or leapfrog (KDK), with or without Kahan compensation,
// one launch a step and one C call a chunk.
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
// Bound: kernel B1's (the fp64 pipe, 40 instructions a pair, and the
// fold's latency) plus the launch; the update is a few ops a body.

#include <cuda_runtime.h>

#include "f64_force.cuh"
#include "sim_step.cuh"

namespace {

using Geo = nbody::F64Block;
using Args = nbody::SimArgs<double>;

// Step t from buffer in into buffer out; `next`: form what step t + 1
// reads (every step but a chunk's last)
template <int dist3, int integ, bool comp>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
sim_step_f64_kernel(Args a, const double* __restrict__ in,
                    double* __restrict__ out, int t, int next) {
    __shared__ typename Geo::Smem sm;

    const long long S = a.slot;
    const int i0 = blockIdx.x * Geo::R, live = min(Geo::R, a.n - i0);
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
    if (next && x % 3 == 0) nbody::sim_form_gm(a, out, i0 + x / 3, t + 1);
}

template <int dist3, int integ, bool comp>
int chunk(const Args& a, double* buf[2], int t0, int t1, cudaStream_t s) {
    const dim3 grid((a.n + Geo::R - 1) / Geo::R);
    return nbody::sim_chunk<double, integ, comp>(
        a, buf, t0, t1, s, [&](double* in, double* out, int t, int next) {
            sim_step_f64_kernel<dist3, integ, comp>
                <<<grid, Geo::THREADS, 0, s>>>(a, in, out, t, next);
        });
}

template <int dist3>
int by_variant(int integ, bool comp, const Args& a, double* buf[2], int t0,
               int t1, cudaStream_t s) {
    using nbody::SIM_EULER;
    using nbody::SIM_LEAPFROG;
    if (integ == SIM_EULER)
        return comp ? chunk<dist3, SIM_EULER, true>(a, buf, t0, t1, s)
                    : chunk<dist3, SIM_EULER, false>(a, buf, t0, t1, s);
    return comp ? chunk<dist3, SIM_LEAPFROG, true>(a, buf, t0, t1, s)
                : chunk<dist3, SIM_LEAPFROG, false>(a, buf, t0, t1, s);
}

}  // namespace

// Steps t0 + 1 .. t1 of simulate's binary64 loop on one scene of n bodies.
// st0, st1: two buffers of SIM_SLOTS * n * 3 doubles; st0 holds the state
// in its slots q, v (and a for the leapfrog, qc, vc with compensation),
// and the state after step t1 lies in the same slots of st0 if t1 - t0 is
// even, else of st1. m0, mh (n,); fst (t1 + 1,) at least. integrator: 0
// Euler, 1 leapfrog; dist3: 1 dsqrt, 2 sqrt3 (native/core.cc's numbers).
// One launch forms the chunk's first inputs, then one launch a step; no
// host synchronisation. Returns the first launch error, or
// cudaErrorInvalidValue without launching.
extern "C" int sim_chunk_f64_launch(double* st0, double* st1,
                                    const double* m0, const double* mh,
                                    const double* fst, int n, int integrator,
                                    int compensated, int dist3, double G,
                                    double dt, double kick, double eps2,
                                    int t0, int t1, void* stream) {
    if (!nbody::sim_chunk_args_ok(n, integrator, t0, t1)
        || (compensated != 0 && compensated != 1)
        || (dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{m0, mh, fst, n, 3LL * n, G, dt, kick, eps2};
    double* buf[2] = {st0, st1};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool comp = compensated != 0;
    return dist3 == nbody::DIST3_DSQRT
               ? by_variant<nbody::DIST3_DSQRT>(integrator, comp, a, buf, t0,
                                                t1, s)
               : by_variant<nbody::DIST3_SQRT3>(integrator, comp, a, buf, t0,
                                                t1, s);
}

// The slots of a state buffer of every step kernel (sim_step.cuh), for
// the wrappers
extern "C" int sim_step_slots() { return nbody::SIM_SLOTS; }
