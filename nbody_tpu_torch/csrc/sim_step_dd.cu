// simulate()'s double-double step on one device (precisions 'tf3', 'ddp'
// and 'dd+'): masses, kernel B4's force and the update, Euler or leapfrog
// (KDK), one launch a step and one C call a chunk, whose launches a CUDA
// graph replays (sim_step.cuh: each launch takes its offset in the chunk
// and reads the chunk's base step from a device word).
//
// Replaces, on simulate's path beyond binary64, the JAX package's tf3
// scan (nbody_tpu/simulate.py _chunk_scan, its tf3 branch around
// nbody_tpu/ops/forces.py::pairwise_accel_tf3), in double-double where
// the JAX package carries triple-float32 (accel_dd.cu says why).
// sim_step.cuh has the step's ops in double-double (dd.cuh, the op
// sequences of ops/ddfloat): m_eff = m0 + mh * (fst[t], 0), gm = m_eff *
// (G, 0), each x += a*h as dd_add(x, dd_mul(a, (h, 0))), the ops of
// ops/integrate._axpy_dd; there is no compensation. The force is kernel
// B4's block force (dd_force.cuh, geometry DdNarrow, gm from a table), so
// a chunk is bit-equal to the eager loop around kernel B4 (and to its
// plain version, ops/sim_step.sim_chunk_dd_ref).
//
// Launch t's block owns B4's 4 rows: its compute threads make the pair
// terms over the sources p (leapfrog) or q (Euler) and gm; its fold lane
// (row, component) reads the component's state before the fold, then
// updates it and forms what step t + 1 reads of it (the lane of the row's
// first component its gm).
//
// The mesh (sim_rows_dd_step, the Blocked instantiation): a launch takes
// a rank's rows [r0, end) and every row's position (sim_step.cuh has the
// layout), and forms the next step's gm for all n bodies; the host
// gathers the positions between two launches. Replaces, on simulate's
// mesh path beyond binary64, the JAX package's tf3 chunk scan inside
// shard_map (nbody_tpu/simulate.py _chunk_scan_mesh).
//
// Bound: kernel B4's (the fp64 pipe, 333 instructions a pair) plus the
// launch; the update is a few dozen fp64 ops a body.

#include <cuda_runtime.h>

#include "dd_force.cuh"
#include "forces.cuh"
#include "sim_step.cuh"

namespace {

using nbody::dd;
using Geo = nbody::DdNarrow;
using Args = nbody::SimArgs<dd>;

// The step at offset `off` in its chunk from buffer in into buffer out;
// `next`: form what the step after it reads (every step but a chunk's
// last); Blocked: a mesh rank's rows
template <int integ, bool Blocked>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
sim_step_dd_kernel(Args a, const dd* __restrict__ in, dd* __restrict__ out,
                   int off, int next) {
    __shared__ Geo::Smem sm;

    if (Blocked && next)
        nbody::sim_form_gm_all(a, out, nbody::sim_step_at(a, off) + 1);
    const long long S = a.slot;
    const int i0 = (Blocked ? a.r0 : 0) + blockIdx.x * Geo::R;
    const int live = min(Geo::R, (Blocked ? a.end : a.n) - i0);
    if (Blocked && live <= 0) return;   // a rank without rows
    const dd* pos = in + nbody::sim_pos_slot<integ>() * S;
    nbody::dd_rows_qi<Geo>(pos + 3LL * i0, live, sm);
    if (threadIdx.x < Geo::NC) {
        // the sources (n, 3): one block of n rows
        nbody::dd_rows_terms<Geo>(pos, nbody::Blocks{a.n, 0}, a.n, a.eps2,
                                  nbody::DdGmTable{in + nbody::SLOT_GM * S},
                                  sm);
        return;
    }
    int x;
    const bool folds = nbody::dd_fold_lane<Geo>(live, x);
    const long long e = 3LL * i0 + x;
    nbody::SimLane<dd> s{};
    if (folds) s = nbody::sim_load<dd, integ, false>(a, in, e);
    const dd acc = nbody::dd_rows_fold<Geo>(a.n, folds, sm);
    if (!folds) return;
    nbody::sim_update<dd, integ, false>(a, s, acc, out, e, next);
    if (!Blocked && next && x % 3 == 0)
        nbody::sim_form_gm(a, out, i0 + x / 3,
                           nbody::sim_step_at(a, off) + 1);
}

template <int integ>
int chunk(const Args& a, dd* buf[2], int K, cudaStream_t s, int* launched) {
    const dim3 grid((a.n + Geo::R - 1) / Geo::R);
    return nbody::sim_chunk<dd, integ, false>(
        a, buf, K, s, launched, [&](dd* in, dd* out, int off, int next) {
            sim_step_dd_kernel<integ, false>
                <<<grid, Geo::THREADS, 0, s>>>(a, in, out, off, next);
        });
}

// A mesh rank's launch: the step at offset `off` from in into out, or
// with out null the chunk's pre-launch on in for that step
template <int integ>
int rows_step(const Args& a, dd* in, dd* out, int off, int next,
              cudaStream_t s) {
    if (out == nullptr)
        return nbody::sim_pre<dd, integ, false>(a, in, off, s);
    sim_step_dd_kernel<integ, true>
        <<<nbody::sim_rows_grid(a, Geo::R), Geo::THREADS, 0, s>>>(
            a, in, out, off, next);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Steps t0 + 1 .. t0 + K of simulate's double-double loop on one scene of
// n bodies, t0 = *t0w read on the card (a device word), every value a pair
// of doubles (hi, lo). st0, st1: two buffers of SIM_SLOTS * n * 3 pairs;
// st0 holds the state in its slots q, v (and a for the leapfrog), and the
// state after step t0 + K lies in the same slots of st0 if K is even, else
// of st1. m0, mh (n,) pairs; fst (t0 + K + 1,) doubles at least; G, dt and
// kick = dt / 2 binary64 values (taken as (x, 0)), eps2 = eps2_hi +
// eps2_lo. integrator: 0 Euler, 1 leapfrog. One launch forms the chunk's
// first inputs, then one launch a step; *launched (a host int) is set to
// the launches made. No host synchronisation, and nothing the host does
// depends on t0 (a capture of the call serves every chunk of K steps).
// Returns the first launch error, or cudaErrorInvalidValue without
// launching.
extern "C" int sim_chunk_dd_launch(double* st0, double* st1,
                                   const double* m0, const double* mh,
                                   const double* fst, int n, int integrator,
                                   double G, double dt, double kick,
                                   double eps2_hi, double eps2_lo,
                                   const int* t0w, int K, int* launched,
                                   void* stream) {
    if (!nbody::sim_chunk_args_ok(n, integrator, t0w, K)
        || launched == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    *launched = 0;
    Args a{reinterpret_cast<const dd*>(m0),
                 reinterpret_cast<const dd*>(mh),
                 fst,
                 n,
                 3LL * n,
                 dd{G, 0.0},
                 dd{dt, 0.0},
                 dd{kick, 0.0},
                 dd{eps2_hi, eps2_lo}};
    a.t0 = t0w;
    dd* buf[2] = {reinterpret_cast<dd*>(st0), reinterpret_cast<dd*>(st1)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return integrator == nbody::SIM_EULER
               ? chunk<nbody::SIM_EULER>(a, buf, K, s, launched)
               : chunk<nbody::SIM_LEAPFROG>(a, buf, K, s, launched);
}

// One launch of a mesh rank (sim_step.cuh, the row-range form), as
// sim_rows_f64_step (sim_step_f64.cu) has it, every value a pair of
// doubles; the other arguments are sim_chunk_dd_launch's.
extern "C" int sim_rows_dd_step(double* in, double* out, const double* m0,
                                const double* mh, const double* fst, int n,
                                int ni, int k, int r0, int integrator,
                                double G, double dt, double kick,
                                double eps2_hi, double eps2_lo,
                                const int* t0w, int off, int next,
                                void* stream) {
    Args a{reinterpret_cast<const dd*>(m0),
           reinterpret_cast<const dd*>(mh),
           fst,
           n,
           3LL * n,
           dd{G, 0.0},
           dd{dt, 0.0},
           dd{kick, 0.0},
           dd{eps2_hi, eps2_lo}};
    if (!nbody::sim_rows_args(a, ni, k, r0, integrator, t0w, off,
                              out != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    dd* i = reinterpret_cast<dd*>(in);
    dd* o = reinterpret_cast<dd*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return integrator == nbody::SIM_EULER
               ? rows_step<nbody::SIM_EULER>(a, i, o, off, next, s)
               : rows_step<nbody::SIM_LEAPFROG>(a, i, o, off, next, s);
}

// What the card says of the step kernel of this integrator (forces.cuh
// kernel_info).
extern "C" int sim_step_dd_info(int integrator, int* out) {
    if (!nbody::sim_args_ok(1, integrator))
        return static_cast<int>(cudaErrorInvalidValue);
    return integrator == nbody::SIM_EULER
               ? nbody::kernel_info(
                     sim_step_dd_kernel<nbody::SIM_EULER, false>,
                     Geo::THREADS, Geo::R, out)
               : nbody::kernel_info(
                     sim_step_dd_kernel<nbody::SIM_LEAPFROG, false>,
                     Geo::THREADS, Geo::R, out);
}
