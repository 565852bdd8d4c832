// simulate()'s step on one device, shared by its three step kernels:
// binary64 (sim_step_f64.cu, kernel B1's force), float32 (sim_step_f32.cu,
// kernel B2's) and double-double (sim_step_dd.cu, kernel B4's). This header
// holds what they share: the state buffer's slots, the update of one
// (row, component) after its force, what a step forms for the next one,
// the launch that forms them for a chunk's first step, and the chunk loop.
//
// Replaces the per-step work that the JAX package compiles into one scan
// per chunk (nbody_tpu/simulate.py _chunk_scan) around its force. Per step
// t, for every body and component, in the order of the port's eager loops
// (ops/sim_step.py eager_chunk and eager_chunk_dd, ops/integrate.py):
//
//   gm_j  = ((m0_j + mh_j * fst[t]) * G)
//   Euler:    a = force(q);  v += a*dt;  q += v*dt
//   leapfrog: v += a*kick;  q += v*dt;  a = force(q);  v += a*kick
//
// with kick = dt / 2 and, with compensation (float and double only), each
// x += d as ops/sim_step.comp_add: y = d - c; t = x + y; c = (t - x) - y.
// Every op is rn_add, rn_sub or rn_mul of the state's type T (graded.cuh,
// dd.cuh): a round-to-nearest intrinsic, or the double-double op of
// ops/ddfloat. The library is built with -fmad=false, so the compensation's
// (t - x) - y survives and a step kernel is bit-equal to the eager loop
// around its force kernel.
//
// Layout: the state lives in a buffer of slots of n * 3 values each
// (SimSlot): q, v, a, qc, vc as the host sees them after a step, then what
// the next step's force reads: the leapfrog's drifted positions p, its
// half-kicked velocities vh and their compensations, and gm of the step
// (n values). A chunk of K steps from step t0 is a launch of
// sim_pre_kernel, which forms those from the state for the chunk's first
// step, then one launch of the step kernel a step over a ping-pong pair of
// buffers: launch t reads buffer in and writes buffer out, so no block
// reads what another writes, and the kernel boundary is the grid-wide
// barrier that the leapfrog's drift needs. In launch t, the thread that
// owns a (row, component) once the block force is summed updates it
// (sim_update) and, unless t ends the chunk, forms what step t + 1 reads of
// it; the owner of a row's first component forms its gm (sim_form_gm).
// Each body's per-step work is done once, not once a pair.
//
// A launch takes its offset k in the chunk (1 .. K; the pre-launch 1) by
// value and reads t0 from a device word (SimArgs t0), t = *t0 + k: the only
// thing a step takes from its absolute number is fst[t]. So the chunk's
// launches, captured once into a CUDA graph (ops/sim_step.py), serve every
// chunk of K steps wherever it starts, as the graded chunk's do
// (graded.cuh GradedArgs s0).

#pragma once

#include <cuda_runtime.h>

#include "dd.cuh"
#include "graded.cuh"

namespace nbody {

enum SimIntegrator : int { SIM_EULER = 0, SIM_LEAPFROG = 1 };

// the slots of a state buffer, n * 3 values each (SLOT_GM holds n)
enum SimSlot : int {
    SLOT_Q = 0, SLOT_V = 1, SLOT_A = 2, SLOT_QC = 3, SLOT_VC = 4,
    SLOT_P = 5, SLOT_VH = 6, SLOT_PC = 7, SLOT_VHC = 8, SLOT_GM = 9,
    SIM_SLOTS = 10
};

// The oscillation table's values for a state of type T: T's own, or a
// binary64 value for double-double, taken as (f, 0) as ops/ddfloat.const
// takes it
template <typename T>
struct SimReal {
    using type = T;
    __device__ __forceinline__ static T of(T x) { return x; }
};
template <>
struct SimReal<dd> {
    using type = double;
    __device__ __forceinline__ static dd of(double x) { return {x, 0.0}; }
};

template <typename T>
struct SimArgs {
    const T* m0;                            // (n,) base masses
    const T* mh;                            // (n,) device half-masses
    const typename SimReal<T>::type* fst;   // (steps + 1,) oscillation table
    int n;
    long long slot;                         // rows * 3: n one device, k * ni
                                            // on the mesh
    T G, dt, kick, eps2;
    int r0, end;   // the mesh: this launch's rows [r0, end)
    int tile;      // the float32 mesh: the ordered sum's source groups
    const int* t0;  // the chunk's base step, on the device
};

// The step at offset `off` in the launch's chunk
template <typename T>
__device__ __forceinline__ int sim_step_at(const SimArgs<T>& a, int off) {
    return *a.t0 + off;
}

// x += d with running compensation c (ops/sim_step.comp_add): returns the
// new x in x2 and the new compensation in c2
template <typename T>
__device__ __forceinline__ void comp_add(T x, T c, T d, T& x2, T& c2) {
    const T y = rn_sub(d, c);
    x2 = rn_add(x, y);
    c2 = rn_sub(rn_sub(x2, x), y);
}

// x += d, compensated or not
template <typename T, bool comp>
__device__ __forceinline__ void sim_add(T x, T c, T d, T& x2, T& c2) {
    if constexpr (comp)
        comp_add(x, c, d, x2, c2);
    else
        x2 = rn_add(x, d);
}

// gm of body i for step t, into the slot the step's force reads
template <typename T>
__device__ __forceinline__ void sim_form_gm(const SimArgs<T>& a, T* st,
                                            long long i, int t) {
    st[SLOT_GM * a.slot + i] = graded_gm(a.m0[i], a.mh[i],
                                         SimReal<T>::of(a.fst[t]), a.G);
}

// gm of every body for step t, by every thread of the grid (the mesh's
// launches, which each update only their rank's rows)
template <typename T>
__device__ __forceinline__ void sim_form_gm_all(const SimArgs<T>& a, T* st,
                                                int t) {
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < a.n; i += static_cast<long long>(gridDim.x) * blockDim.x)
        sim_form_gm(a, st, i, t);
}

// The leapfrog's first kick and drift of one component from its state
// (q, v, acc, qc, vc), into the slots the next step's force reads
template <typename T, bool comp>
__device__ __forceinline__ void kick_drift(const SimArgs<T>& a, T q, T v,
                                           T acc, T qc, T vc, T* st,
                                           long long e) {
    const long long S = a.slot;
    T vh, vhc, p, pc;
    sim_add<T, comp>(v, vc, rn_mul(acc, a.kick), vh, vhc);
    sim_add<T, comp>(q, qc, rn_mul(vh, a.dt), p, pc);
    st[SLOT_VH * S + e] = vh;
    st[SLOT_P * S + e] = p;
    if constexpr (comp) {
        st[SLOT_VHC * S + e] = vhc;
        st[SLOT_PC * S + e] = pc;
    }
}

// What the step at offset `off` reads of element e (body e / 3), formed
// from the state in the same buffer: gm, and the leapfrog's kick and drift
template <typename T, int integ, bool comp>
__global__ void __launch_bounds__(256)
sim_pre_kernel(SimArgs<T> a, T* __restrict__ st, int off) {
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    const long long S = a.slot;
    if (e >= 3LL * a.n) return;
    if (e % 3 == 0) sim_form_gm(a, st, e / 3, sim_step_at(a, off));
    if constexpr (integ == SIM_LEAPFROG) {
        const T zero{};
        kick_drift<T, comp>(a, st[SLOT_Q * S + e], st[SLOT_V * S + e],
                            st[SLOT_A * S + e],
                            comp ? st[SLOT_QC * S + e] : zero,
                            comp ? st[SLOT_VC * S + e] : zero, st, e);
    }
}

// The position slot a step's force reads: the drifted p (leapfrog) or q
template <int integ>
__device__ __forceinline__ int sim_pos_slot() {
    return integ == SIM_LEAPFROG ? SLOT_P : SLOT_Q;
}

// One component's state as step t reads it from buffer in: q or p, v or
// vh, and their compensations
template <typename T>
struct SimLane {
    T q, v, qc, vc;
};

template <typename T, int integ, bool comp>
__device__ __forceinline__ SimLane<T> sim_load(const SimArgs<T>& a,
                                               const T* __restrict__ in,
                                               long long e) {
    const long long S = a.slot;
    const bool lf = integ == SIM_LEAPFROG;
    SimLane<T> s{};
    s.q = in[(lf ? SLOT_P : SLOT_Q) * S + e];
    s.v = in[(lf ? SLOT_VH : SLOT_V) * S + e];
    if constexpr (comp) {
        s.qc = in[(lf ? SLOT_PC : SLOT_QC) * S + e];
        s.vc = in[(lf ? SLOT_VHC : SLOT_VC) * S + e];
    }
    return s;
}

// Step t's update of element e from its state s and its force acc, into
// buffer out; `next`: form what step t + 1 reads of it (its gm apart)
template <typename T, int integ, bool comp>
__device__ __forceinline__ void sim_update(const SimArgs<T>& a,
                                           const SimLane<T>& s, T acc,
                                           T* __restrict__ out, long long e,
                                           int next) {
    const long long S = a.slot;
    const T h = integ == SIM_LEAPFROG ? a.kick : a.dt;
    T v2, vc2{};
    sim_add<T, comp>(s.v, s.vc, rn_mul(acc, h), v2, vc2);
    out[SLOT_V * S + e] = v2;
    if constexpr (comp) out[SLOT_VC * S + e] = vc2;
    if constexpr (integ == SIM_EULER) {
        T q2, qc2{};
        sim_add<T, comp>(s.q, s.qc, rn_mul(v2, a.dt), q2, qc2);
        out[SLOT_Q * S + e] = q2;
        if constexpr (comp) out[SLOT_QC * S + e] = qc2;
    } else {
        out[SLOT_Q * S + e] = s.q;
        if constexpr (comp) out[SLOT_QC * S + e] = s.qc;
        out[SLOT_A * S + e] = acc;
        if (next) kick_drift<T, comp>(a, s.q, v2, acc, s.qc, vc2, out, e);
    }
}

// The K steps of a chunk from buffer buf[0]: sim_pre_kernel, then
// step(in, out, k, next) launches the step at offset k from buf[in] into
// buf[out] (next: k < K). The state ends in buf[K & 1]. Nothing here
// depends on the chunk's base step, which the kernels read from a.t0.
// Returns the first launch error, or 0.
template <typename T, int integ, bool comp>
int sim_pre(const SimArgs<T>& a, T* st, int off, cudaStream_t s) {
    sim_pre_kernel<T, integ, comp>
        <<<static_cast<unsigned>((3LL * a.n + 255) / 256), 256, 0, s>>>(
            a, st, off);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int integ, bool comp, class Step>
int sim_chunk(const SimArgs<T>& a, T* buf[2], int K, cudaStream_t s,
              Step step) {
    cudaError_t err =
        static_cast<cudaError_t>(sim_pre<T, integ, comp>(a, buf[0], 1, s));
    for (int k = 1; k <= K && err == cudaSuccess; ++k) {
        const int in = (k - 1) & 1;
        step(buf[in], buf[in ^ 1], k, static_cast<int>(k < K));
        err = cudaGetLastError();
    }
    return static_cast<int>(err);
}

// Whether a scene and integrator are ones the launchers take
inline bool sim_args_ok(int n, int integrator) {
    return n > 0 && (integrator == SIM_EULER || integrator == SIM_LEAPFROG);
}

// ... and a chunk of K steps from the base step in the word t0
inline bool sim_chunk_args_ok(int n, int integrator, const int* t0, int K) {
    return sim_args_ok(n, integrator) && t0 != nullptr && K >= 1;
}

// A mesh rank's launch (the step kernels' sim_rows_*_step): n rows in k
// blocks of ni = ceil(n / k), this rank's from r0, a block's first row,
// at offset off >= 1 in its chunk (off >= 0 for the chunk's pre-launch)
// from the base step in the word t0; sets a's slot size, rows and word,
// false if refused.
template <typename T>
bool sim_rows_args(SimArgs<T>& a, int ni, int k, int r0, int integrator,
                   const int* t0, int off, bool step) {
    if (!sim_chunk_args_ok(a.n, integrator, t0, 1) || k < 1
        || ni != (a.n + k - 1) / k || r0 < 0 || r0 % ni != 0
        || r0 / ni >= k || off < (step ? 1 : 0))
        return false;
    a.t0 = t0;
    a.slot = 3LL * k * ni;
    a.r0 = r0;
    a.end = std::min(r0 + ni, a.n);
    return true;
}

// The grid of a mesh rank's step launch: its rows in blocks of `rows`,
// one block at least (a rank without rows still forms gm)
template <typename T>
dim3 sim_rows_grid(const SimArgs<T>& a, int rows) {
    return dim3(static_cast<unsigned>(
        std::max(1, (a.end - a.r0 + rows - 1) / rows)));
}

}  // namespace nbody
