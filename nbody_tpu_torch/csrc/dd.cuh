// Double-double binary64 arithmetic for the kernels of precision 'tf3'
// (accel_dd.cu, kernel B4; graded_step_dd.cu, the graded step B4'), and
// their pair term and fold.
//
// A value is the unevaluated sum hi + lo of two doubles, |lo| <= ulp(hi)/2:
// about 106 bits, with binary64's range, so the raw graded scenes need no
// rescale and no exponent gauges (the JAX package's triple-float32 needs
// both: nbody_tpu/ops/forces.py:60-81). Every function is the op sequence
// of its twin in ops/ddfloat.py, each op a round-to-nearest intrinsic, so
// the kernels and the twins give the same bits. The library is built with
// -fmad=false; the one fused multiply-add is the exact product error of
// two_prod, written as __fma_rn, whose value the twin computes exactly by
// Dekker's splitting.

#pragma once

#include <cuda_runtime.h>

namespace nbody {

struct dd {
    double hi, lo;
};

__device__ __forceinline__ dd two_sum(double a, double b) {
    const double s = __dadd_rn(a, b);
    const double bb = __dsub_rn(s, a);
    return {s, __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb))};
}

// exact when |a| >= |b|
__device__ __forceinline__ dd fast_two_sum(double a, double b) {
    const double s = __dadd_rn(a, b);
    return {s, __dsub_rn(b, __dsub_rn(s, a))};
}

__device__ __forceinline__ dd two_prod(double a, double b) {
    const double p = __dmul_rn(a, b);
    return {p, __fma_rn(a, b, -p)};
}

__device__ __forceinline__ dd dd_neg(dd a) { return {-a.hi, -a.lo}; }

// the accurate sum: both halves' errors kept
__device__ __forceinline__ dd dd_add(dd a, dd b) {
    dd s = two_sum(a.hi, b.hi);
    const dd t = two_sum(a.lo, b.lo);
    s = fast_two_sum(s.hi, __dadd_rn(s.lo, t.hi));
    return fast_two_sum(s.hi, __dadd_rn(s.lo, t.lo));
}

__device__ __forceinline__ dd dd_sub(dd a, dd b) { return dd_add(a, dd_neg(b)); }

__device__ __forceinline__ dd dd_mul(dd a, dd b) {
    const dd p = two_prod(a.hi, b.hi);
    return fast_two_sum(
        p.hi, __dadd_rn(p.lo, __dadd_rn(__dmul_rn(a.hi, b.lo),
                                         __dmul_rn(a.lo, b.hi))));
}

// a times a double b
__device__ __forceinline__ dd dd_mul_d(dd a, double b) {
    const dd p = two_prod(a.hi, b);
    return fast_two_sum(p.hi, __dadd_rn(p.lo, __dmul_rn(a.lo, b)));
}

// three binary64 quotients, each of the remainder left
__device__ __forceinline__ dd dd_div(dd a, dd b) {
    const double q1 = __ddiv_rn(a.hi, b.hi);
    dd r = dd_sub(a, dd_mul_d(b, q1));
    const double q2 = __ddiv_rn(r.hi, b.hi);
    r = dd_sub(r, dd_mul_d(b, q2));
    const double q3 = __ddiv_rn(r.hi, b.hi);
    return dd_add(fast_two_sum(q1, q2), dd{q3, 0.0});
}

// a > 0: the correctly rounded root and one Newton correction from the
// exact residual
__device__ __forceinline__ dd dd_sqrt(dd a) {
    const double s = __dsqrt_rn(a.hi);
    const dd p = two_prod(s, s);
    const double r =
        __dadd_rn(__dsub_rn(__dsub_rn(a.hi, p.hi), p.lo), a.lo);
    return fast_two_sum(s, __ddiv_rn(r, __dadd_rn(s, s)));
}

__device__ __forceinline__ bool operator<(dd a, dd b) {
    return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}
__device__ __forceinline__ bool operator!=(dd a, dd b) {
    return a.hi != b.hi || a.lo != b.lo;
}

// the graded drivers' generic arithmetic (graded.cuh) in double-double
__device__ __forceinline__ dd rn_add(dd a, dd b) { return dd_add(a, b); }
__device__ __forceinline__ dd rn_sub(dd a, dd b) { return dd_sub(a, b); }
__device__ __forceinline__ dd rn_mul(dd a, dd b) { return dd_mul(a, b); }

// The pair terms of K rows i against one source j (kernels B4 and B4'),
// the physics of kernel B1's in double-double:
//   dx = q_j - q_i;  d2 = ((dx*dx + dy*dy) + dz*dz) + eps2
//   w = gm_j / (d2 * sqrt(d2));  t = w * dx
// The j == i term is 0 (dx is exactly 0) and is folded like any other.
// Each step is taken for all K rows before the next, so that K independent
// chains are in flight; every row's ops are the same, in the same order.
template <int K>
__device__ __forceinline__ void dd_pair_terms(
        dd xj, dd yj, dd zj, dd gmj, const dd (&xi)[K], const dd (&yi)[K],
        const dd (&zi)[K], dd eps2, dd (&t)[K][3]) {
    dd dx[K], dy[K], dz[K], d2[K], w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        dx[k] = dd_sub(xj, xi[k]);
        dy[k] = dd_sub(yj, yi[k]);
        dz[k] = dd_sub(zj, zi[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
        d2[k] = dd_add(dd_add(dd_add(dd_mul(dx[k], dx[k]),
                                     dd_mul(dy[k], dy[k])),
                              dd_mul(dz[k], dz[k])),
                       eps2);
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = dd_mul(d2[k], dd_sqrt(d2[k]));
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = dd_div(gmj, w[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
        t[k][0] = dd_mul(w[k], dx[k]);
        t[k][1] = dd_mul(w[k], dy[k]);
        t[k][2] = dd_mul(w[k], dz[k]);
    }
}

// The fold over ascending j (ops/ddfloat.fold_add): the his summed with
// two_sum, the errors and the terms' los summed apart; only the hi chain
// is carried from term to term, one add of latency a term.
__device__ __forceinline__ void dd_fold_add(dd& acc, dd t) {
    const dd s = two_sum(acc.hi, t.hi);
    acc.hi = s.hi;
    acc.lo = __dadd_rn(acc.lo, __dadd_rn(s.lo, t.lo));
}

__device__ __forceinline__ dd dd_fold_end(dd acc) {
    return fast_two_sum(acc.hi, acc.lo);
}

}  // namespace nbody
