// The graded drivers' per-step checks on the card, shared by the fp64 and
// fp32 graded step kernels (graded_step_f64.cu, graded_step_f32.cu), and
// the host loop that advances one chunk of steps.
//
// A chunk from step s0 to s1 is s1 - s0 launches of a step kernel, one per
// step t, and one launch of a check kernel. The launch of step t writes the
// state of step t into the other buffer of a ping-pong pair, so no block
// reads positions another block is writing and no grid-wide barrier is
// needed. Before its step, block (0, 0) of the launch of step t runs the
// checks of step t - 1 on the state that launch t - 1 wrote (complete at
// the kernel boundary); the check kernel runs those of step s1. The checks
// write only the decision carries (min d2, hit, arrivals, snapshots,
// flags), which no other block of the launch reads, with one exception:
// the arrival steps that the fused driver's Problem-3 rows read to find out
// whether they mirror the Problem-2 row. They live in two buffers: the
// checks of step p read arr[(p + 1) & 1] and write arr[p & 1], so the
// launch that checks step p reads, in every block, the arrivals as they
// stood before step p. No atomics: every result is bitwise repeatable.
//
// The checks are the drivers' (models/direct_sum.py), in their order:
//   P12  (rows P1 devices off, P2 devices on): min of P1's planet-asteroid
//        d2 (torch.minimum: NaN wins); while P2 runs (B == 2), each device's
//        arrival (its planet-device d2 below the missile's md2[p]), the
//        (q, v) snapshot of P2 at that arrival, and P2's first hit.
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

#pragma once

#include <cuda_runtime.h>

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
};

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

// |q_planet - q_other|^2 in one scenario row
template <typename T>
__device__ __forceinline__ T planet_d2(const T* row, int planet,
                                       long long other) {
    const T* p = row + static_cast<size_t>(planet) * 3;
    const T* o = row + static_cast<size_t>(other) * 3;
    const T dx = rn_sub(p[0], o[0]);
    const T dy = rn_sub(p[1], o[1]);
    const T dz = rn_sub(p[2], o[2]);
    return rn_add(rn_add(rn_mul(dx, dx), rn_mul(dy, dy)), rn_mul(dz, dz));
}

// Copy one scenario row of (q, v), `row` values each, into (qd, vd), with
// every thread of the block.
template <typename T>
__device__ void copy_row(const T* q, const T* v, T* qd, T* vd, size_t row) {
    for (size_t x = threadIdx.x; x < row; x += blockDim.x) {
        qd[x] = q[x];
        vd[x] = v[x];
    }
}

// The checks of step p on the state (q, v) of step p, by every thread of
// one block. `mirror`: copy the P2 row into the P3 rows that were pending
// before p (the check kernel at a chunk's end; within a chunk the next
// step's launch reads P2 in their place).
template <typename T>
__device__ void graded_check(const GradedArgs<T>& a, T* q, T* v, int p,
                             bool mirror) {
    const int tid = threadIdx.x;
    const size_t row = static_cast<size_t>(a.n) * 3;
    if (a.mode == MODE_P3) {
        for (int b = tid; b < a.B; b += blockDim.x)
            if (a.arr[0][b] < p
                && planet_d2(q + b * row, a.planet, a.others[0]) < a.r2)
                a.flag[b] = 1;
        return;
    }
    if (tid == 0) {
        const T d = planet_d2(q, a.planet, a.others[0]);
        const T m = *a.min_d2;
        if (d < m || d != d) *a.min_d2 = d;
    }
    if (a.B == 1) return;  // P12 after the P2 early exit: P1 alone
    const T* q1 = q + row;
    const long long* arr_rd = a.arr[(p + 1) & 1];
    long long* arr_wr = a.arr[p & 1];
    for (int k = tid; k < a.D; k += blockDim.x) {
        const long long before = arr_rd[k];
        const bool pending = before == -2;
        const long long now =
            pending && planet_d2(q1, a.planet, a.others[1 + k]) < a.md2[p]
                ? p : before;
        arr_wr[k] = now;
        if (a.mode == MODE_P123) {
            const T* qk = pending ? q1 : q + (2 + k) * row;
            if (now != -2 && planet_d2(qk, a.planet, a.others[0]) < a.r2)
                a.flag[k] = 1;
        }
    }
    if (tid == 0 && *a.hit == -2
        && planet_d2(q1, a.planet, a.others[0]) < a.r2)
        *a.hit = p;
    if (a.mode == MODE_P12) {
        __syncthreads();  // arr_wr is complete
        for (int k = 0; k < a.D; ++k)
            if (arr_wr[k] == p)  // arrivals happen only at the step checked
                copy_row(q1, v + row, a.q_snap + k * row, a.v_snap + k * row,
                         row);
    } else if (mirror) {
        for (int k = 0; k < a.D; ++k)
            if (arr_rd[k] == -2)
                copy_row(q1, v + row, q + (2 + k) * row, v + (2 + k) * row,
                         row);
    }
}

// Whether scenario row b waits at step t: a P3 row before its arrival
// carries its state through unchanged.
template <typename T>
__device__ __forceinline__ bool graded_frozen(const GradedArgs<T>& a, int b,
                                              int t) {
    return a.mode == MODE_P3 && !(a.arr[0][b] < t);
}

// Bodies i0 .. i0 + count - 1 of scenario row b copied from (q, v) to
// (qo, vo), with every thread of the block.
template <typename T>
__device__ void copy_bodies(const T* q, const T* v, T* qo, T* vo, int b,
                            int i0, int count, int n) {
    const size_t base = static_cast<size_t>(b) * n * 3;
    const size_t hi = base + static_cast<size_t>(min(i0 + count, n)) * 3;
    for (size_t x = base + static_cast<size_t>(i0) * 3 + threadIdx.x; x < hi;
         x += blockDim.x) {
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

inline bool graded_args_ok(int mode, int B, int n, int D, int s0, int s1) {
    return mode >= MODE_P12 && mode <= MODE_P123 && B >= 1 && B <= 65535
           && n >= 1 && D >= 0 && s0 >= 0 && s1 > s0;
}

// Steps s0 + 1 .. s1 from the state in (q0, v0); the result lies in
// (q0, v0) if s1 - s0 is even, else in (q1, v1). No host synchronisation.
// `smem`: the step kernel's dynamic shared memory in bytes. Returns the
// first launch error, or 0.
template <typename T, typename Step, typename Check>
int graded_chunk(Step step, Check check, dim3 grid,
                 int threads, int check_threads, const GradedArgs<T>& a,
                 T* q0, T* v0, T* q1, T* v1, int s0, int s1,
                 cudaStream_t stream, size_t smem = 0) {
    T* q[2] = {q0, q1};
    T* v[2] = {v0, v1};
    for (int t = s0 + 1; t <= s1; ++t) {
        const int in = (t - s0 - 1) & 1;
        step<<<grid, threads, smem, stream>>>(a, q[in], v[in], q[in ^ 1],
                                              v[in ^ 1], t, t > s0 + 1);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int last = (s1 - s0) & 1;
    check<<<1, check_threads, 0, stream>>>(a, q[last], v[last], s1);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace nbody
