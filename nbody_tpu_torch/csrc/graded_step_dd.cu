// The graded step in double-double (B4'): kernel B4's force, the Euler
// update and the graded drivers' checks, one launch per step, for the
// graded solve at precision 'tf3' (graded.cuh has the chunk loop, the
// ping-pong buffers and the checks, all generic in the value type).
//
// Replaces, on the graded path, the JAX package's triple-float32 scans
// (nbody_tpu/models/direct_sum.py _p12_chunk, _p123_chunk, _p3_chunks with
// TF3 carries, whose force is ops/forces.py::pairwise_accel_tf3). Per step
// t and scenario row b, every quantity double-double:
//
//   gm_j = (m0_j + mh_j * fst[t]) * G
//   a_i  = fold over ascending j of B4's pair term (dd.cuh, dd_force.cuh)
//   v_i' = v_i + a_i*dt;  q_i' = q_i + v_i'*dt
//
// and the checks compare double-double d2 with r2 = pr*pr and md2[t] =
// (fl64(speed*dt)*t)^2, as the JAX package's tf3 drivers build them
// (direct_sum.py:246-248, 282-284). Bitwise equal to the plain dd chunks
// of ops/graded_step.py, whose force is kernel B4.
//
// Layout: the block of B4 (dd_force.cuh: DD_R rows of one scenario row,
// grid ceil(n / DD_R) x B), the fold lane applying the Euler update to its
// component. Bound: B4's, about 330 fp64 instructions a pair, plus the
// launch. Waste the bound does not count: every compute thread forms gm_j
// again for its pair, about 38 fp64 instructions (some 11% of the pair's
// work), where once a source and step would do.

#include <cuda_runtime.h>

#include "dd_force.cuh"
#include "graded.cuh"

namespace {

using nbody::dd;
using nbody::GradedArgs;

constexpr int CHECK_THREADS = 256;

__global__ void __launch_bounds__(nbody::DD_THREADS)
graded_step_dd_kernel(GradedArgs<dd> a, const dd* __restrict__ q_in,
                      const dd* __restrict__ v_in, dd* __restrict__ q_out,
                      dd* __restrict__ v_out, int t, int check) {
    __shared__ nbody::DdRowsSmem sm;
    const int b = blockIdx.y, i0 = blockIdx.x * nbody::DD_R;
    const int n = a.n;
    const size_t row = static_cast<size_t>(n) * 3;
    if (check && blockIdx.x == 0 && b == 0)
        nbody::graded_check(a, const_cast<dd*>(q_in), const_cast<dd*>(v_in),
                            t - 1, false);
    if (nbody::graded_frozen(a, b, t)) {
        nbody::copy_bodies(q_in, v_in, q_out, v_out, b, i0, nbody::DD_R, n);
        return;
    }
    const int src = nbody::graded_source_row(a, b, t, check);
    const dd* qb = q_in + src * row;
    const dd* vb = v_in + src * row;
    const size_t mb = static_cast<size_t>(b) * n;
    const dd f = a.fst[t];
    dd acc;
    size_t x;
    if (nbody::dd_rows_accel(
            qb, n, i0, a.eps2,
            [&](int j) {
                return nbody::graded_gm(a.m0[mb + j], a.mh[mb + j], f, a.G);
            },
            sm, acc, x))
        nbody::graded_euler(acc, qb[x], vb[x], a.dt, q_out[b * row + x],
                            v_out[b * row + x]);
}

__global__ void __launch_bounds__(CHECK_THREADS)
graded_check_dd_kernel(GradedArgs<dd> a, dd* q, dd* v, int p) {
    nbody::graded_check(a, q, v, p, true);
}

}  // namespace

// Steps s0 + 1 .. s1 of a graded driver (mode 0 P12, 1 P3, 2 P123) from
// the state (q, v), (B, n, 3) double-double each as pairs of doubles; the
// result lies in (q, v) if s1 - s0 is even, else in (q2, v2). The real
// tables and carries are double-double too; G, dt, eps2 and r2 come as
// (hi, lo). Otherwise as graded_chunk_f64_launch.
extern "C" int graded_chunk_dd_launch(
        double* q, double* v, double* q2, double* v2, const double* m0,
        const double* mh, const double* fst, const double* md2,
        const long long* others, long long* arr, long long* arr2,
        long long* hit, unsigned char* flag, double* min_d2, double* q_snap,
        double* v_snap, int mode, int B, int n, int D, int planet,
        double G_hi, double G_lo, double dt_hi, double dt_lo, double eps2_hi,
        double eps2_lo, double r2_hi, double r2_lo, int s0, int s1,
        void* stream) {
    if (!nbody::graded_args_ok(mode, B, n, D, s0, s1))
        return static_cast<int>(cudaErrorInvalidValue);
    auto d = [](double* p) { return reinterpret_cast<dd*>(p); };
    auto cd = [](const double* p) { return reinterpret_cast<const dd*>(p); };
    const GradedArgs<dd> a{cd(m0), cd(mh), cd(fst), cd(md2), others,
                           {arr, arr2}, hit, flag, d(min_d2), d(q_snap),
                           d(v_snap), mode, B, n, D, planet, dd{G_hi, G_lo},
                           dd{dt_hi, dt_lo}, dd{eps2_hi, eps2_lo},
                           dd{r2_hi, r2_lo}};
    const dim3 grid((n + nbody::DD_R - 1) / nbody::DD_R, B);
    return nbody::graded_chunk(
        graded_step_dd_kernel, graded_check_dd_kernel, grid,
        nbody::DD_THREADS, CHECK_THREADS, a, d(q), d(v), d(q2), d(v2), s0, s1,
        static_cast<cudaStream_t>(stream));
}
