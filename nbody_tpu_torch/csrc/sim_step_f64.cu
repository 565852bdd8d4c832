// simulate()'s binary64 step on one device: masses, kernel B1's force and
// the update, Euler or leapfrog (KDK), with or without Kahan compensation,
// one launch a step and one C call a chunk.
//
// Replaces, on simulate's binary64 path, nbody_tpu/ops/pallas_forces_e64.py
// ::_e64_kernel together with the per-step work around it that the JAX
// package compiles into one scan per chunk (nbody_tpu/simulate.py
// _chunk_scan). Per step t, for every body and component, in the order of
// the port's eager loop (ops/sim_step.py eager_chunk, ops/integrate.py):
//
//   gm_j  = fl(fl(m0_j + fl(mh_j * fst[t])) * G)
//   Euler:    a = force(q);  v += a*dt;  q += v*dt
//   leapfrog: v += a*kick;  q += v*dt;  a = force(q);  v += a*kick
//
// where force is kernel B1's (forces.cuh b1_pair_term folded over
// ascending j), kick = dt / 2, and, with compensation, each x += d is
// ops/sim_step.comp_add: y = d - c; t = x + y; c = (t - x) - y. Every op is
// a round-to-nearest intrinsic and the library is built with -fmad=false,
// so the compensation's (t - x) - y survives and the result is bit-equal
// to the eager loop around kernel B1 (and to its plain version,
// ops/sim_step.sim_chunk_f64_ref).
//
// Layout: the state lives in a buffer of slots of n * 3 doubles each
// (SLOT_*): q, v, a, qc, vc as the host sees them after a step, then what
// the next step's force reads: the leapfrog's drifted positions p, its
// half-kicked velocities vh and their compensations, and gm of the step.
// A chunk is a launch of sim_pre_kernel, which forms those from the state
// for the chunk's first step, then one launch of the step kernel a step
// over a ping-pong pair of buffers: launch t reads buffer in and writes
// buffer out, so no block reads what another writes, and the kernel
// boundary is the grid-wide barrier that the leapfrog's drift needs.
// Launch t's block owns R rows: its force is the binary64 block force
// (f64_force.cuh) over the sources p (leapfrog) or q (Euler) and gm, in
// B1's geometry; its fold lane (row, component) then
// updates its component and, unless t ends the chunk, forms what step t+1
// reads of it (the first kick and the drift, once a component, and gm,
// once a body) with the eager loop's ops in its order. Each body's
// per-step work is done once, not once a pair.
//
// Bound: kernel B1's (the fp64 pipe, 40 instructions a pair, and the
// fold's latency) plus the launch; the update is a few ops a body.

#include <cuda_runtime.h>

#include "f64_force.cuh"
#include "graded.cuh"

namespace {

using Geo = nbody::F64Block;

enum Integrator : int { EULER = 0, LEAPFROG = 1 };

// the slots of a state buffer, n * 3 doubles each (SLOT_GM holds n)
enum Slot : int {
    SLOT_Q = 0, SLOT_V = 1, SLOT_A = 2, SLOT_QC = 3, SLOT_VC = 4,
    SLOT_P = 5, SLOT_VH = 6, SLOT_PC = 7, SLOT_VHC = 8, SLOT_GM = 9,
    SLOTS = 10
};

struct SimArgs {
    const double* m0;    // (n,) base masses
    const double* mh;    // (n,) device half-masses
    const double* fst;   // (steps + 1,) oscillation table
    int n;
    long long slot;      // n * 3
    double G, dt, kick, eps2;
};

// x += d with running compensation c (ops/sim_step.comp_add): returns the
// new x in x2 and the new compensation in c2
__device__ __forceinline__ void comp_add(double x, double c, double d,
                                         double& x2, double& c2) {
    const double y = __dsub_rn(d, c);
    x2 = __dadd_rn(x, y);
    c2 = __dsub_rn(__dsub_rn(x2, x), y);
}

// The leapfrog's first kick and drift of one component from its state
// (q, v, acc, qc, vc), into the slots the next step's force reads
template <bool comp>
__device__ __forceinline__ void kick_drift(const SimArgs& a, double q,
                                           double v, double acc, double qc,
                                           double vc, double* st,
                                           long long e) {
    const long long S = a.slot;
    if constexpr (comp) {
        double vh, vhc, p, pc;
        comp_add(v, vc, __dmul_rn(acc, a.kick), vh, vhc);
        comp_add(q, qc, __dmul_rn(vh, a.dt), p, pc);
        st[SLOT_VH * S + e] = vh;
        st[SLOT_VHC * S + e] = vhc;
        st[SLOT_P * S + e] = p;
        st[SLOT_PC * S + e] = pc;
    } else {
        const double vh = __dadd_rn(v, __dmul_rn(acc, a.kick));
        st[SLOT_VH * S + e] = vh;
        st[SLOT_P * S + e] = __dadd_rn(q, __dmul_rn(vh, a.dt));
    }
}

// What step t reads of element e (body e / 3), formed from the state in
// the same buffer: gm, and the leapfrog's kick and drift
template <int integ, bool comp>
__global__ void __launch_bounds__(256)
sim_pre_kernel(SimArgs a, double* __restrict__ st, int t) {
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    const long long S = a.slot;
    if (e >= S) return;
    if (e % 3 == 0) {
        const long long i = e / 3;
        st[SLOT_GM * S + i] = nbody::graded_gm(a.m0[i], a.mh[i], a.fst[t],
                                               a.G);
    }
    if constexpr (integ == LEAPFROG)
        kick_drift<comp>(a, st[SLOT_Q * S + e], st[SLOT_V * S + e],
                         st[SLOT_A * S + e], comp ? st[SLOT_QC * S + e] : 0.0,
                         comp ? st[SLOT_VC * S + e] : 0.0, st, e);
}

// Step t from buffer in into buffer out; `next`: form what step t + 1
// reads (every step but a chunk's last)
template <int dist3, int integ, bool comp>
__global__ void __launch_bounds__(Geo::THREADS, Geo::MINB)
sim_step_f64_kernel(SimArgs a, const double* __restrict__ in,
                    double* __restrict__ out, int t, int next) {
    __shared__ typename Geo::Smem sm;

    const long long S = a.slot;
    const int i0 = blockIdx.x * Geo::R, live = min(Geo::R, a.n - i0);
    const double* pos = in + (integ == LEAPFROG ? SLOT_P : SLOT_Q) * S;
    nbody::f64_rows_qi<Geo>(pos + 3LL * i0, live, sm);
    if (threadIdx.x < Geo::NC) {
        const nbody::F64Table sources{pos, in + SLOT_GM * S};
        nbody::f64_rows_terms<Geo, dist3>(sources, a.n, live, a.eps2, sm);
        return;
    }
    int x;
    const bool folds = nbody::f64_fold_lane<Geo>(live, x);
    const long long e = 3LL * i0 + x;
    // the lane's state, read before the fold: q or p, v or vh, and their
    // compensations
    double q = 0.0, v = 0.0, qc = 0.0, vc = 0.0;
    if (folds) {
        q = pos[e];
        v = in[(integ == LEAPFROG ? SLOT_VH : SLOT_V) * S + e];
        if (comp) {
            qc = in[(integ == LEAPFROG ? SLOT_PC : SLOT_QC) * S + e];
            vc = in[(integ == LEAPFROG ? SLOT_VHC : SLOT_VC) * S + e];
        }
    }
    const double acc = nbody::f64_rows_fold<Geo>(a.n, folds, sm);
    if (!folds) return;
    const double h = integ == LEAPFROG ? a.kick : a.dt;
    double v2, vc2 = 0.0;
    if (comp)
        comp_add(v, vc, __dmul_rn(acc, h), v2, vc2);
    else
        v2 = __dadd_rn(v, __dmul_rn(acc, h));
    out[SLOT_V * S + e] = v2;
    if (comp) out[SLOT_VC * S + e] = vc2;
    if constexpr (integ == EULER) {
        double q2, qc2 = 0.0;
        if (comp)
            comp_add(q, qc, __dmul_rn(v2, a.dt), q2, qc2);
        else
            q2 = __dadd_rn(q, __dmul_rn(v2, a.dt));
        out[SLOT_Q * S + e] = q2;
        if (comp) out[SLOT_QC * S + e] = qc2;
    } else {
        out[SLOT_Q * S + e] = q;
        if (comp) out[SLOT_QC * S + e] = qc;
        out[SLOT_A * S + e] = acc;
        if (next) kick_drift<comp>(a, q, v2, acc, qc, vc2, out, e);
    }
    if (next && x % 3 == 0) {
        const int i = i0 + x / 3;
        out[SLOT_GM * S + i] = nbody::graded_gm(a.m0[i], a.mh[i],
                                                a.fst[t + 1], a.G);
    }
}

// Steps t0 + 1 .. t1 from buffer buf[0]; the state ends in buf[(t1 - t0)
// & 1]. Returns the first launch error, or 0.
template <int dist3, int integ, bool comp>
int chunk(const SimArgs& a, double* buf[2], int t0, int t1,
          cudaStream_t s) {
    sim_pre_kernel<integ, comp>
        <<<static_cast<unsigned>((a.slot + 255) / 256), 256, 0, s>>>(
            a, buf[0], t0 + 1);
    cudaError_t err = cudaGetLastError();
    const dim3 grid((a.n + Geo::R - 1) / Geo::R);
    for (int t = t0 + 1; t <= t1 && err == cudaSuccess; ++t) {
        const int in = (t - t0 - 1) & 1;
        sim_step_f64_kernel<dist3, integ, comp>
            <<<grid, Geo::THREADS, 0, s>>>(a, buf[in], buf[in ^ 1], t,
                                           t < t1);
        err = cudaGetLastError();
    }
    return static_cast<int>(err);
}

template <int dist3>
int by_variant(int integ, bool comp, const SimArgs& a, double* buf[2],
               int t0, int t1, cudaStream_t s) {
    if (integ == EULER)
        return comp ? chunk<dist3, EULER, true>(a, buf, t0, t1, s)
                    : chunk<dist3, EULER, false>(a, buf, t0, t1, s);
    return comp ? chunk<dist3, LEAPFROG, true>(a, buf, t0, t1, s)
                : chunk<dist3, LEAPFROG, false>(a, buf, t0, t1, s);
}

}  // namespace

// Steps t0 + 1 .. t1 of simulate's binary64 loop on one scene of n bodies.
// st0, st1: two buffers of SLOTS * n * 3 doubles; st0 holds the state in
// its slots q, v (and a for the leapfrog, qc, vc with compensation), and
// the state after step t1 lies in the same slots of st0 if t1 - t0 is
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
    if (n <= 0 || t0 < 0 || t1 <= t0
        || (integrator != EULER && integrator != LEAPFROG)
        || (compensated != 0 && compensated != 1)
        || (dist3 != nbody::DIST3_DSQRT && dist3 != nbody::DIST3_SQRT3))
        return static_cast<int>(cudaErrorInvalidValue);
    const SimArgs a{m0, mh, fst, n, 3LL * n, G, dt, kick, eps2};
    double* buf[2] = {st0, st1};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool comp = compensated != 0;
    return dist3 == nbody::DIST3_DSQRT
               ? by_variant<nbody::DIST3_DSQRT>(integrator, comp, a, buf, t0,
                                                t1, s)
               : by_variant<nbody::DIST3_SQRT3>(integrator, comp, a, buf, t0,
                                                t1, s);
}

// The slots of a state buffer (sim_chunk_f64_launch), for the wrapper
extern "C" int sim_step_f64_slots() { return SLOTS; }
