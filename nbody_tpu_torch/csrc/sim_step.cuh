// simulate()'s step on one device, shared by its three step kernels:
// binary64 (sim_step_f64.cu, kernel B1's force), float32 (sim_step_f32.cu,
// kernel B2's) and double-double (sim_step_dd.cu, kernel B4's). This header
// holds what they share: the state buffer's slots, the update of one
// (row, component) after its force, what a step forms for the next one,
// the launch that forms them for a chunk's first step, and the chunk's
// two drivers: a launch a step (sim_chunk) and one persistent launch a
// chunk (sim_persistent, sim_coop_launch).
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
// (n values). A chunk of K steps from step t0 runs over a ping-pong pair
// of buffers: step k reads buffer in = buf[(k - 1) & 1] and writes the
// other, out, so no block reads what another writes in the same step. In
// step t, the thread that owns a (row, component) once the block force is
// summed updates it (sim_update) and, unless t ends the chunk, forms what
// step t + 1 reads of it; the owner of a row's first component forms its
// gm (sim_form_gm). Each body's per-step work is done once, not once a
// pair. The leapfrog's drift needs every body's kicked position before
// the next force, and the next force reads every body's gm of step t + 1:
// between two steps the whole grid must have written out.
//
// A launch a step (sim_chunk; the double-double kernel, the mesh's
// row-range launches, and the binary64 and float32 kernels on one device
// above the n where their persistent chunk pays, as the row-range form on
// all n rows: sim_whole): sim_pre_kernel forms step t0 + 1's inputs, then one
// launch a step, the kernel boundary being the grid-wide barrier. A launch
// takes its offset k in the chunk (1 .. K; the pre-launch 1) by value and
// reads t0 from a device word (SimArgs t0), t = *t0 + k: the only thing a
// step takes from its absolute number is fst[t]. So the chunk's launches,
// captured once into a CUDA graph (ops/sim_step.py), serve every chunk of
// K steps wherever it starts, as the graded chunk's do (graded.cuh
// GradedArgs s0).
//
// One persistent launch a chunk (sim_persistent; the one-device binary64
// and float32 kernels up to their PERSISTENT_MAX_N): each block stays
// resident for the whole chunk. It
// reads t0 from the word once, forms step t0 + 1's inputs over a
// grid-stride range of elements (phase 0), then for k = 1 .. K waits at a
// grid barrier and walks its row blocks rb = blockIdx.x, + gridDim.x, ...
// of step t0 + k. Under the graph a launch a step still cost the device
// 3.2 us (fp64) and 3.9 us (fp32) a step that does nothing (PERF.md: the
// grid's drain and refill); a barrier takes its place. Where trouble lies:
//   * Co-residency. A grid barrier deadlocks unless every block of the
//     grid is resident at once. The launch is cooperative
//     (cudaLaunchAttributeCooperative, which refuses a grid that cannot
//     be co-resident with cudaErrorCooperativeLaunchTooLarge, returned to
//     the caller: there is no fallback to a launch a step), and the grid
//     is min(row blocks, co-resident blocks), the latter from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor for the exact kernel
//     and block size times the SMs (sim_grid, cached per device and
//     kernel). Any n works: a block walks as many row blocks as it must.
//   * The barrier: cooperative_groups' grid sync. Its atomics order every
//     write of the step before any read of the next, gpu-wide. It uses
//     barrier 0 of the block; the binary64 force's named barriers are
//     1 .. 1 + 2 * NBUF (f64_force.cuh), so they never meet.
//   * Stale reads. In one launch every state buffer is written by other
//     blocks while the kernel runs, so no load of it may take the
//     non-coherent path (ld.global.nc, LDG.E.CONSTANT in the SASS), which
//     the compiler may choose for a pointer it can prove read-only for the
//     kernel's life (const T* __restrict__, __ldg). No pointer into the
//     state buffers carries __restrict__ on this path (sim_load,
//     sim_update, f64_force.cuh F64Src and f64_rows_qi, f32_force.cuh's
//     block force). cp.async (f32_force.cuh b2_stage) is a weak load,
//     ordered by the barrier like any other. chip_smoke.py counts the
//     .CONSTANT loads in the persistent kernels' SASS (none) and holds
//     2000-step chunks bitwise against the launch-a-step row-range form.
//   * Shared memory between row blocks. A block that walks a second row
//     block of the same step reuses its shared tiles: a __syncthreads
//     separates the two.
//   * The barrier's own cost is what the design buys against the launch
//     floor: chip_smoke.py times a chunk of grid syncs alone
//     (sim_barrier_*).
//     On an H100 a barrier costs about what a launch of a CUDA graph's
//     chain does (1.05 to 1.3 us, PERF.md), and a persistent kernel holds
//     more registers and no read-only loads; so each kernel runs one
//     persistent launch a chunk only up to the n where that measured
//     faster (PERSISTENT_MAX_N in its source), and a launch a step above.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "dd.cuh"
#include "forces.cuh"
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

// What step t reads of element e (body e / 3), formed from the state in
// the same buffer: gm, and the leapfrog's kick and drift
template <typename T, int integ, bool comp>
__device__ __forceinline__ void sim_pre_elem(const SimArgs<T>& a, T* st,
                                             long long e, int t) {
    const long long S = a.slot;
    if (e % 3 == 0) sim_form_gm(a, st, e / 3, t);
    if constexpr (integ == SIM_LEAPFROG) {
        const T zero{};
        kick_drift<T, comp>(a, st[SLOT_Q * S + e], st[SLOT_V * S + e],
                            st[SLOT_A * S + e],
                            comp ? st[SLOT_QC * S + e] : zero,
                            comp ? st[SLOT_VC * S + e] : zero, st, e);
    }
}

// ... as a launch for the step at offset `off`, a thread an element
template <typename T, int integ, bool comp>
__global__ void __launch_bounds__(256)
sim_pre_kernel(SimArgs<T> a, T* __restrict__ st, int off) {
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (e < 3LL * a.n)
        sim_pre_elem<T, integ, comp>(a, st, e, sim_step_at(a, off));
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
                                               const T* in, long long e) {
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
                                           T* out, long long e, int next) {
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

// The K steps of a chunk from buffer buf[0], a launch a step:
// sim_pre_kernel, then step(in, out, k, next) launches the step at offset
// k from buf[in] into buf[out] (next: k < K). The state ends in
// buf[K & 1]. Nothing here depends on the chunk's base step, which the
// kernels read from a.t0. Each launch made without error adds one to
// *launched. Returns the first launch error, or 0.
template <typename T, int integ, bool comp>
int sim_pre(const SimArgs<T>& a, T* st, int off, cudaStream_t s) {
    sim_pre_kernel<T, integ, comp>
        <<<static_cast<unsigned>((3LL * a.n + 255) / 256), 256, 0, s>>>(
            a, st, off);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int integ, bool comp, class Step>
int sim_chunk(const SimArgs<T>& a, T* buf[2], int K, cudaStream_t s,
              int* launched, Step step) {
    cudaError_t err =
        static_cast<cudaError_t>(sim_pre<T, integ, comp>(a, buf[0], 1, s));
    if (err == cudaSuccess) ++*launched;
    for (int k = 1; k <= K && err == cudaSuccess; ++k) {
        const int in = (k - 1) & 1;
        step(buf[in], buf[in ^ 1], k, static_cast<int>(k < K));
        err = cudaGetLastError();
        if (err == cudaSuccess) ++*launched;
    }
    return static_cast<int>(err);
}

// The K steps of a chunk in one persistent launch, called by every thread
// of a cooperative grid: phase 0 forms step t0 + 1's inputs in st0 (t0
// read from the word once); then each step k = 1 .. K, after a
// cooperative_groups grid sync, runs step(in, out, rb, t0 + k, next)
// for each of the `rows` row blocks rb that fall to this block (rb =
// blockIdx.x + i * gridDim.x), in = st0 for odd k, else st1, out the
// other, next = k < K. The state ends in st0 if K is even, else in st1,
// as sim_chunk leaves it.
template <typename T, int integ, bool comp, class Step>
__device__ __forceinline__ void sim_persistent(const SimArgs<T>& a, T* st0,
                                               T* st1, int K, int rows,
                                               Step step) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const int t0 = *a.t0;
    const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         e < 3LL * a.n; e += threads)
        sim_pre_elem<T, integ, comp>(a, st0, e, t0 + 1);
    for (int k = 1; k <= K; ++k) {
        grid.sync();
        T* in = (k & 1) ? st0 : st1;
        T* out = (k & 1) ? st1 : st0;
        for (int rb = blockIdx.x; rb < rows; rb += gridDim.x) {
            step(in, out, rb, t0 + k, static_cast<int>(k < K));
            if (rb + static_cast<int>(gridDim.x) < rows)
                __syncthreads();   // the block's shared tiles, reused
        }
    }
}

// A chunk of K grid syncs alone, in the grid of a persistent chunk: what
// a barrier costs (chip_smoke.py)
template <int THREADS>
__global__ void __launch_bounds__(THREADS) sim_barrier_kernel(int K) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int k = 1; k <= K; ++k) grid.sync();
}

// The grid of a persistent launch of `kernel` at `threads` a block (no
// dynamic shared memory) over `rows` row blocks: min(rows, the blocks of
// that kernel the current device holds at once, cap if cap > 0), in
// *grid; the blocks an SM holds in *per_sm (if not null). The occupancy
// query is made once per device and kernel. Returns the CUDA error, or 0.
inline int sim_grid(const void* kernel, int threads, int rows, int cap,
                    int* grid, int* per_sm = nullptr) {
    static std::mutex mu;
    static std::map<std::pair<int, const void*>, std::pair<int, int>> seen;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    std::pair<int, int> fit;   // (blocks an SM, SMs)
    {
        const std::lock_guard<std::mutex> lock(mu);
        const auto it = seen.find({dev, kernel});
        if (it != seen.end()) {
            fit = it->second;
        } else {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &fit.first, kernel, threads, 0);
            if (err == cudaSuccess)
                err = cudaDeviceGetAttribute(
                    &fit.second, cudaDevAttrMultiProcessorCount, dev);
            if (err != cudaSuccess) return static_cast<int>(err);
            seen.emplace(std::make_pair(dev, kernel), fit);
        }
    }
    if (per_sm != nullptr) *per_sm = fit.first;
    int g = std::min(rows, fit.first * fit.second);
    if (cap > 0) g = std::min(g, cap);
    if (g < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    *grid = g;
    return 0;
}

// A cooperative launch of `kernel` (every block resident at once, or
// refused) on `grid` blocks of `threads`. Returns the launch error, or 0.
template <typename... Params, typename... Args>
int sim_coop_launch(void (*kernel)(Params...), int grid, int threads,
                    cudaStream_t s, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    const cudaError_t last = cudaGetLastError();   // and clear it
    return static_cast<int>(err != cudaSuccess ? err : last);
}

// The row-range form's arguments for one device's whole scene (one block
// of n rows): what a launch a step of a one-device chunk takes
template <typename T>
SimArgs<T> sim_whole(SimArgs<T> a) {
    a.r0 = 0;
    a.end = a.n;
    return a;
}

// A persistent chunk of `kernel` over `rows` row blocks: its grid
// (sim_grid, at most `cap` blocks if cap > 0), then the cooperative
// launch kernel(args...), which adds one to *launched if made without
// error. Returns the first CUDA error, or 0.
template <int THREADS, typename... Params, typename... Args>
int sim_persistent_launch(void (*kernel)(Params...), int rows, int cap,
                          cudaStream_t s, int* launched, Args... args) {
    int grid = 0;
    int err = sim_grid(reinterpret_cast<const void*>(kernel), THREADS, rows,
                       cap, &grid);
    if (err == 0) err = sim_coop_launch(kernel, grid, THREADS, s, args...);
    if (err == 0) ++*launched;
    return err;
}

// K grid syncs alone in the grid that `kernel` would take over `rows` row
// blocks (at most `cap` blocks if cap > 0)
template <int THREADS, typename... Params>
int sim_barrier_launch(void (*kernel)(Params...), int rows, int cap, int K,
                       cudaStream_t s) {
    int grid = 0;
    const int err = sim_grid(reinterpret_cast<const void*>(kernel), THREADS,
                             rows, cap, &grid);
    return err != 0 ? err
                    : sim_coop_launch(sim_barrier_kernel<THREADS>, grid,
                                      THREADS, s, K);
}

// What the card says of a persistent kernel of `threads` a block and
// `rows_per_block` rows a row block over `rows` row blocks: out =
// {registers, local bytes, threads, resident blocks an SM, rows a row
// block (forces.cuh kernel_info), grid, row blocks}. Returns the CUDA
// error, or 0.
template <class Kernel>
int sim_persistent_info(Kernel* kernel, int threads, int rows_per_block,
                        int rows, int* out) {
    int err = kernel_info(kernel, threads, rows_per_block, out);
    if (err == 0)
        err = sim_grid(reinterpret_cast<const void*>(kernel), threads, rows,
                       0, &out[5]);
    out[6] = rows;
    return err;
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
