// The graded drivers' per-step checks on the card, shared by the graded
// step kernels (graded_step_f64.cu, graded_step_f32.cu, graded_step_dd.cu),
// and the host loops that advance them: a chunk of steps on one device, or
// one step of a rank of the mesh.
//
// A chunk of K steps from step s0 is K launches of a step kernel, one per
// step t = s0 + k (k = 1 .. K, its offset in the chunk), and one launch of
// a check kernel (the binary64 fused driver at small n is one launch of
// a cluster that runs all of it: graded_step_f64.cu's resident chunk). A
// launch takes its offset by value and reads s0 from a device word
// (GradedArgs s0), so that the loop, captured once into a CUDA graph
// (ops/graded_step.py), serves every chunk of K steps: everything
// that depends on the absolute step (fst[t], md2[p], the parity of the
// arrival buffers, the Problem-3 freeze test, the fused driver's source
// row) is computed on the card from *s0 + k. The launch of step t writes the
// state of step t into the other buffer of a ping-pong pair, so no block
// reads positions another block is writing and no grid-wide barrier is
// needed. Before its step, block (0, 0) of the launch of step t runs the
// checks of step t - 1 on the state that launch t - 1 wrote (complete at
// the kernel boundary); the check kernel runs those of step s0 + K. The
// checks write only the decision carries (min d2, hit, arrivals,
// snapshots, flags), which no other block of the launch reads, with one
// exception:
// the arrival steps that the fused driver's Problem-3 rows read to find out
// whether they mirror the Problem-2 row. They live in two buffers: the
// checks of step p read arr[(p + 1) & 1] and write arr[p & 1], so the
// launch that checks step p reads, in every block, the arrivals as they
// stood before step p. Both buffers hold the same arrivals on entry to a
// chunk, and the check kernel leaves them so at its end: the arrivals of a
// chunk's last step lie in arr[0] whatever its parity. No atomics: every
// result is bitwise repeatable.
//
// The checks are the drivers' (models/direct_sum.py), in their order:
//   P12  (rows P1 devices off, P2 devices on): min of P1's planet-asteroid
//        d2 (torch.minimum: NaN wins); while P2 runs (B == 2), each device's
//        arrival (its planet-device d2 below the missile's md2[p]), the
//        (q, v) snapshot of P2 at that arrival, and P2's first hit. The
//        rows are named by roles (GradedArgs p1, p2): one device has P1 in
//        row 0 and P2 in row 1 while P2 runs, P1 alone after the P2 early
//        exit; a mesh whose 'scen' axis splits the two has one of them.
//   P3   (one row per destroyed device, from its arrival snapshot): rows
//        active at p (arr[b] < p) are flagged when they hit.
//   P123 (rows P1, P2, then P3 rows): the P12 checks, then each P3 row
//        still pending before p (its missile had not arrived) is the P2
//        row's copy, so its d2 is P2's, and a row flags a hit from its
//        arrival on. The copy of P2 into pending rows (the mirror) is made
//        by the readers: the launch of step p + 1 reads the P2 row in
//        place of a row that was pending before p; the check kernel at a
//        chunk's end copies it.
// d2 = ((dx*dx + dy*dy) + dz*dz) with d = q_planet - q_other, every op
// round-to-nearest (ops/forces.sq_dist).
//
// The state is read and written in blocks of rows (blocks.cuh): one block
// of n rows on one device, k blocks on a mesh of k body ranks, where a
// launch computes the rows [r0, r0 + ni) of one rank and reads every row.
// Every rank makes the same checks on the same gathered state, so their
// carries agree without a collective (the JAX package's mesh design).

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "blocks.cuh"

namespace nbody {

enum GradedMode : int { MODE_P12 = 0, MODE_P3 = 1, MODE_P123 = 2 };

template <typename T>
struct GradedArgs {
    const T* m0;               // (B, n) base masses
    const T* mh;               // (B, n) device half-masses
    const T* fst;              // (n_steps + 1,) oscillation table
    const T* md2;              // (n_steps + 1,) missile radius squared
    const long long* others;   // (1 + D,) the asteroid, then the devices
    long long* arr[2];         // arrivals (D,) by parity; P3: (B,), read only
    long long* hit;            // P12, P123: () first hit step of P2
    unsigned char* flag;       // P3: (B,) hit; P123: (D,) Problem-3 hit
    T* min_d2;                 // P12, P123: () running min of P1's d2
    T* q_snap;                 // P12: (D, n, 3) P2 at each arrival
    T* v_snap;
    int mode, B, n, D, planet;
    T G, dt, eps2, r2;
    int p1, p2;   // P12, P123: the scenario rows of P1 and P2; -1 if absent
    int r0;       // this launch's rows: [r0, min(r0 + L.ni, n))
    Blocks L;     // the state's layout
    int tile;     // float32 on the mesh: the ordered sum's source groups
                  // (f32_force.cuh GroupTiles); unused elsewhere
    const int* s0;  // the chunk's base step, on the device
};

// The arguments of a chunk on one device: all n rows in one block, P1 in
// row 0 and P2 in row 1 while it runs (P12 at B = 2, P123)
template <typename T>
GradedArgs<T> graded_args(const T* m0, const T* mh, const T* fst,
                          const T* md2, const long long* others,
                          long long* arr, long long* arr2, long long* hit,
                          unsigned char* flag, T* min_d2, T* q_snap,
                          T* v_snap, int mode, int B, int n, int D,
                          int planet, T G, T dt, T eps2, T r2,
                          const int* s0) {
    GradedArgs<T> a{m0, mh, fst, md2, others, {arr, arr2}, hit, flag,
                    min_d2, q_snap, v_snap, mode, B, n, D, planet, G, dt,
                    eps2, r2};
    a.p1 = mode == MODE_P3 ? -1 : 0;
    a.p2 = mode == MODE_P123 || (mode == MODE_P12 && B == 2) ? 1 : -1;
    a.r0 = 0;
    a.L = Blocks{n, static_cast<long long>(B) * n * 3};
    a.tile = 0;
    a.s0 = s0;
    return a;
}

// The step of the launch at offset `off` in its chunk
template <typename T>
__device__ __forceinline__ int graded_step_at(const GradedArgs<T>& a,
                                              int off) {
    return *a.s0 + off;
}

// The end of this launch's rows
template <typename T>
__device__ __forceinline__ int graded_end(const GradedArgs<T>& a) {
    return min(a.r0 + a.L.ni, a.n);
}

__device__ __forceinline__ double rn_add(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ double rn_sub(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ double rn_mul(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float rn_add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float rn_sub(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ float rn_mul(float a, float b) {
    return __fmul_rn(a, b);
}

// gm_j = fl(fl(m0_j + fl(mh_j * f)) * G): m0 + m_half * fst[s], then * G
template <typename T>
__device__ __forceinline__ T graded_gm(T m0, T mh, T f, T G) {
    return rn_mul(rn_add(m0, rn_mul(mh, f)), G);
}

// Euler: v' = v + a*dt, q' = q + v'*dt for one component
template <typename T>
__device__ __forceinline__ void graded_euler(T acc, T q, T v, T dt, T& q2,
                                             T& v2) {
    v2 = rn_add(v, rn_mul(acc, dt));
    q2 = rn_add(q, rn_mul(v2, dt));
}

// |q_planet - q_other|^2 in scenario row b of q
template <typename T>
__device__ __forceinline__ T planet_d2(const GradedArgs<T>& a, const T* q,
                                       int b, long long other) {
    const T* p = q + a.L.at(b, a.planet);
    const T* o = q + a.L.at(b, static_cast<int>(other));
    const T dx = rn_sub(p[0], o[0]);
    const T dy = rn_sub(p[1], o[1]);
    const T dz = rn_sub(p[2], o[2]);
    return rn_add(rn_add(rn_mul(dx, dx), rn_mul(dy, dy)), rn_mul(dz, dz));
}

// Copy scenario row b of (q, v) into (qd, vd), (n, 3) each, with every
// thread of the block.
template <typename T>
__device__ void copy_row(const GradedArgs<T>& a, const T* q, const T* v,
                         int b, T* qd, T* vd) {
    for (int x = threadIdx.x; x < 3 * a.n; x += blockDim.x) {
        const long long y = a.L.at(b, x / 3) + x % 3;
        qd[x] = q[y];
        vd[x] = v[y];
    }
}

// The checks of step p on the state (q, v) of step p, by every thread of
// one block. `closing`, the check kernel at a chunk's end: copy the P2 row
// into the P3 rows that were pending before p (within a chunk the next
// step's launch reads P2 in their place), and leave the arrivals in both
// buffers.
template <typename T>
__device__ void graded_check(const GradedArgs<T>& a, T* q, T* v, int p,
                             bool closing) {
    const int tid = threadIdx.x;
    const size_t row = static_cast<size_t>(a.n) * 3;
    if (a.mode == MODE_P3) {
        for (int b = tid; b < a.B; b += blockDim.x)
            if (a.arr[0][b] < p && planet_d2(a, q, b, a.others[0]) < a.r2)
                a.flag[b] = 1;
        return;
    }
    if (tid == 0 && a.p1 >= 0) {
        const T d = planet_d2(a, q, a.p1, a.others[0]);
        const T m = *a.min_d2;
        if (d < m || d != d) *a.min_d2 = d;
    }
    if (a.p2 < 0) return;  // P1 alone (after the P2 early exit, or a mesh)
    const int p2 = a.p2;
    long long* arr_rd = a.arr[(p + 1) & 1];
    long long* arr_wr = a.arr[p & 1];
    for (int k = tid; k < a.D; k += blockDim.x) {
        const long long before = arr_rd[k];
        const bool pending = before == -2;
        const long long now =
            pending && planet_d2(a, q, p2, a.others[1 + k]) < a.md2[p]
                ? p : before;
        arr_wr[k] = now;
        if (a.mode == MODE_P123) {
            const int bk = pending ? p2 : 2 + k;
            if (now != -2 && planet_d2(a, q, bk, a.others[0]) < a.r2)
                a.flag[k] = 1;
        }
    }
    if (tid == 0 && *a.hit == -2 && planet_d2(a, q, p2, a.others[0]) < a.r2)
        *a.hit = p;
    if (a.mode == MODE_P12) {
        __syncthreads();  // arr_wr is complete
        for (int k = 0; k < a.D; ++k)
            if (arr_wr[k] == p)  // arrivals happen only at the step checked
                copy_row(a, q, v, p2, a.q_snap + k * row, a.v_snap + k * row);
    } else if (closing) {
        // P123 runs on one device only (one block: a row is contiguous)
        for (int k = 0; k < a.D; ++k)
            if (arr_rd[k] == -2)
                copy_row(a, q, v, p2, q + a.L.at(2 + k, 0),
                         v + a.L.at(2 + k, 0));
    }
    if (closing) {
        __syncthreads();  // every read of arr_rd above is done
        for (int k = tid; k < a.D; k += blockDim.x) arr_rd[k] = arr_wr[k];
    }
}

// Whether scenario row b waits at step t: a P3 row before its arrival
// carries its state through unchanged.
template <typename T>
__device__ __forceinline__ bool graded_frozen(const GradedArgs<T>& a, int b,
                                              int t) {
    return a.mode == MODE_P3 && !(a.arr[0][b] < t);
}

// This launch's bodies i0 .. i0 + count - 1 (those before its end) of
// scenario row b copied from (q, v) to (qo, vo), with every thread of the
// block; they lie in one block of the layout, one after another.
template <typename T>
__device__ void copy_bodies(const GradedArgs<T>& a, const T* q, const T* v,
                            T* qo, T* vo, int b, int i0, int count) {
    const int i1 = min(i0 + count, graded_end(a));
    if (i1 <= i0) return;
    const long long base = a.L.at(b, i0);
    const long long hi = base + 3LL * (i1 - i0);
    for (long long x = base + threadIdx.x; x < hi; x += blockDim.x) {
        qo[x] = q[x];
        vo[x] = v[x];
    }
}

// The row scenario row b reads at step t: a fused-driver P3 row that was
// pending before step t - 1 reads the P2 row (the mirror of step t - 1),
// unless the check kernel already copied it.
template <typename T>
__device__ __forceinline__ int graded_source_row(const GradedArgs<T>& a,
                                                 int b, int t, int check) {
    return (a.mode == MODE_P123 && check && b >= 2
            && a.arr[t & 1][b - 2] == -2) ? 1 : b;
}

inline bool graded_args_ok(int mode, int B, int n, int D, const int* s0,
                           int K) {
    return mode >= MODE_P12 && mode <= MODE_P123 && B >= 1 && B <= 65535
           && n >= 1 && D >= 0 && s0 != nullptr && K >= 1;
}

// A mesh rank's chunk (P12 or P3; the mesh has no fused driver): n rows
// in k blocks of ni = ceil(n / k); in P12 each role a row of the B (at
// most 2) rows or -1, B of them present and distinct; in P3 none.
inline bool graded_rows_ok(int mode, int B, int n, int p1, int p2, int ni,
                           int k) {
    if (k < 1 || n < 1 || ni != (n + k - 1) / k) return false;
    if (mode == MODE_P3) return p1 == -1 && p2 == -1;
    return mode == MODE_P12 && B <= 2 && p1 >= -1 && p1 < B && p2 >= -1
           && p2 < B && p1 != p2 && (p1 >= 0) + (p2 >= 0) == B;
}

// Make the arguments `a` of a one-device chunk those of a mesh rank's
// launch: the roles, the layout (each block holds its q rows and then its
// v rows: 2 * B * ni * 3 elements), and the rows from r0, a block's first
// row, at offset `off` in the chunk (a step from 1, the closing checks from
// 0); false if refused.
template <typename T>
bool graded_rows_args(GradedArgs<T>& a, int p1, int p2, int ni, int k,
                      int r0, int off, bool step) {
    if (!graded_args_ok(a.mode, a.B, a.n, a.D, a.s0, 1)
        || !graded_rows_ok(a.mode, a.B, a.n, p1, p2, ni, k) || r0 < 0
        || r0 % ni != 0 || r0 / ni >= k || off < (step ? 1 : 0))
        return false;
    a.p1 = p1;
    a.p2 = p2;
    a.r0 = r0;
    a.L = Blocks{ni, 6LL * a.B * ni};
    return true;
}

// Programmatic dependent launch. A step kernel that a chunk launches as a
// programmatic dependent of the step before it (graded_chunk, Waits) may
// start while that launch's blocks still run: it reads nothing that a
// launch of the chunk writes, and writes nothing, before graded_wait,
// which returns once the launch before it has ended and its writes are
// visible (at once in a plain launch). graded_launch_dependents lets the
// next launch of the stream start once every block of this one has called
// it or exited, so a grid of several waves is whole on the card before the
// next one takes its free slots.
__device__ __forceinline__ void graded_wait() {
    cudaGridDependencySynchronize();
}
__device__ __forceinline__ void graded_launch_dependents() {
    cudaTriggerProgrammaticLaunchCompletion();
}

// A launch of `kernel` on `stream`: as a programmatic dependent of the
// launch before it where `dependent`
// (cudaLaunchAttributeProgrammaticStreamSerialization, a programmatic
// edge in a CUDA graph captured from the stream), else a plain launch.
// Returns the launch error, or 0.
template <typename Kernel, typename... Args>
cudaError_t graded_launch(Kernel kernel, bool dependent, dim3 grid,
                          int threads, size_t smem, cudaStream_t stream,
                          Args... args) {
    if (!dependent) {
        kernel<<<grid, threads, smem, stream>>>(args...);
        return cudaGetLastError();
    }
    cudaLaunchAttribute attr{};
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// Steps s0 + 1 .. s0 + K (s0 = *a.s0, read on the card) from the state in
// (q0, v0); the result lies in (q0, v0) if K is even, else in (q1, v1).
// No host synchronisation, and nothing here depends on s0: a capture of
// this loop serves every chunk of K steps. `smem`: the step kernel's
// dynamic shared memory in bytes. Waits: the step kernel waits for the
// launch before it (graded_wait) before it reads the state, so steps 2 ..
// K are launched as programmatic dependents of the step before; the first
// follows whatever came before the chunk and the check kernel waits for
// the last, both plain launches. Adds each launch made to launched[0] (a
// host int) and, where Waits, each programmatic one to launched[1].
// Returns the first launch error, or 0.
template <bool Waits = false, typename T, typename Step, typename Check>
int graded_chunk(Step step, Check check, dim3 grid,
                 int threads, int check_threads, const GradedArgs<T>& a,
                 T* q0, T* v0, T* q1, T* v1, int K,
                 cudaStream_t stream, int* launched, size_t smem = 0) {
    T* q[2] = {q0, q1};
    T* v[2] = {v0, v1};
    for (int k = 1; k <= K; ++k) {
        const int in = (k - 1) & 1;
        const bool dependent = Waits && k > 1;
        const cudaError_t err = graded_launch(
            step, dependent, grid, threads, smem, stream, a, q[in], v[in],
            q[in ^ 1], v[in ^ 1], k, static_cast<int>(k > 1));
        if (err != cudaSuccess) return static_cast<int>(err);
        ++launched[0];
        if (dependent) ++launched[1];
    }
    const int last = K & 1;
    check<<<1, check_threads, 0, stream>>>(a, q[last], v[last], K);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*launched;
    return static_cast<int>(err);
}

// A mesh rank's launch of the step at offset `off` in its chunk from the
// state (q, v) into (q_out, v_out), checking the step before first if
// `check`; with q_out null, the checks of that step on (q, v) alone (a
// chunk's closing launch). The host gathers the ranks' rows between two
// launches. Returns the launch error, or 0.
template <typename T, typename Step, typename Check>
int graded_rows_launch(Step step, Check check, int rows_a_block,
                       int threads, int check_threads,
                       const GradedArgs<T>& a, T* q, T* v, T* q_out,
                       T* v_out, int off, int check_prev,
                       cudaStream_t stream, size_t smem = 0) {
    if (q_out == nullptr) {
        check<<<1, check_threads, 0, stream>>>(a, q, v, off);
    } else {
        // a rank without rows (r0 past n) still makes the checks
        const int rows = std::min(a.r0 + a.L.ni, a.n) - a.r0;
        const dim3 grid(
            std::max(1, (rows + rows_a_block - 1) / rows_a_block), a.B);
        step<<<grid, threads, smem, stream>>>(a, q, v, q_out, v_out, off,
                                              check_prev);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace nbody
