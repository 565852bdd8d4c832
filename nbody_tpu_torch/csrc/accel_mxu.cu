// Kernel B3: all-pairs softened gravitational acceleration in float32, the
// Gram form of the JAX package's matrix-unit experiment, with its O(n^2)
// accumulation on the tensor cores.
//
// Replaces nbody_tpu/ops/pallas_forces.py::_accel_kernel_mxu (its wrappers
// pallas_accel_mxu and pallas_step_mxu). On the TPU both O(n^2) products ran
// on the matrix unit: the Gram product qi4 (TI, 4) x qj4^T (4, TJ) and the
// accumulation W (TI, TJ) x [qj | 1] (TJ, 4). Per pair:
//
//   g   = (xi*xj + yi*yj) + zi*zj        (the 4th components add 0*1)
//   d2  = (|qi|^2 + (|qj|^2 + eps2)) - 2*g;  d2 = max(d2, eps2/2)
//   inv = rsqrt(d2);  w = gm_j * ((inv*inv)*inv);  w = 0 where j == i
//   acc += w * [xj, yj, zj, 1]
//
// and the epilogue a_i = acc[:3] - acc[3] * qi, the identity
// sum_j w (qj - qi) = sum_j w qj - (sum_j w) qi. The self pair must be
// masked: in the split form w_ii ~ gm/eps^3 lands in both sums and their
// float32 rounding does not cancel.
//
// Precision variants, gram:accum in {highest, default}. highest is float32
// products, default one bf16 pass of the matrix unit (product inputs
// rounded to bfloat16, to nearest with ties to even; products exact; sums
// in float32), as Precision.HIGHEST and Precision.DEFAULT were on the TPU.
//
// The Gram stays on the CUDA cores, op for op as the plain version
// (ops/accel_mxu.accel_mxu_ref) computes it, for both variants: so g, d2
// and w are bitwise the plain version's, and the cancellation in d2 (whose
// relative error grows like (|q| / d)^2) cannot amplify a difference in
// rounding between the two. 2*g is exact, so d2 = fma(-2, g, s) rounds
// once as s - 2*g does. The accumulation W x [qj | 1 | 0 0 0 0] is the
// tensor cores' work, with warp-level mma.sync:
// - default accumulation: one m16n8k16 bf16 mma, w and qj rounded to
//   bfloat16 (exact products, float32 sums), the plain version's bf16 pass;
// - highest:highest: split tf32 on m16n8k8. w = w_hi + w_lo and qj = qj_hi
//   + qj_lo, the hi parts and qj_lo rounded to tf32 by cvt.rn (to nearest,
//   ties to even). The mma's 8 columns hold [qj_hi, 1 | qj_lo, 0], so two
//   mma (w_lo, then w_hi, against the same B) give all four products of
//   the split, and column c + 4 is added to column c at each tile's end:
//   two mma where 3xTF32 takes three and drops w_lo*qj_lo;
// - default:highest: float32 FMAs on the CUDA cores. With a bf16 Gram, a
//   few rows are dominated by one clamped close pair (w near 1e15), and the
//   tensor cores' sum of such a product, cut to 24 bits without rounding
//   to nearest, then cancels in the epilogue: on the bench scene (raw
//   Plummer n = 65536) tf32 on the tensor cores missed the 1e-4 tolerance
//   for this variant, which highest:highest keeps.
// Each thread computes its w values directly in the A-fragment layout of
// the mma it feeds (rows g and g+8, columns t and t+4 for tf32; column
// pairs 2t, 2t+1 and 2t+8, 2t+9 for bf16, g = lane / 4, t = lane % 4), so W
// never goes through shared memory. How an mma adds its products is not
// specified (the order, and whether it truncates), so each chunk's mma
// start from 0 and their sum of 8 or 16 products (16 for split tf32) is
// added to the tile's sum with a float32 add; the tile sums are added to the row's sums in
// ascending tile order, as the plain version adds its tile sums. The FMA
// variant folds the same pairs, each lane its sources of the tile, and
// adds the quad's four lane sums at the tile's end. The tolerance, not the
// bits, is the contract with the plain version; two launches are bitwise
// equal (no atomics, a fixed order).
//
// Layout: q (n, 3), gm (n,) and a (n, 3), contiguous float32. A block of 4
// warps owns BM = 128 rows, each warp 32 (two m16 tiles), and walks the
// sources in tiles of TJ = 128. The raw sources (x, y, z, gm) of the next
// tiles arrive in a 3-deep shared ring by cp.async; once per tile the block
// derives the operands from them (the Gram operand (x, y, z, |qj|^2 +
// eps2), gm, and the mma's B fragment [x, y, z, 1] rounded or split) into
// a 2-deep shared buffer, so each staged source feeds 128 rows. One
// barrier a tile. The self-pair mask runs only on the block's diagonal
// tile (BM = TJ). A ragged last tile is padded with sources of gm = 0 at
// the origin, whose w is exactly 0. The epilogue takes Σw (column 3, held
// by the lane with t = 1) across the quad with one shuffle.
//
// Bound: with the products on the tensor cores, what stays per pair is the
// Gram and w on the CUDA cores (5 in g, 2 in d2, the clamp, 3 in w: 11
// FP32-pipe instructions), the tf32 split (a cvt and a sub) or bf16
// packing (1/2) of w, the add of the mma's sum (1 a pair for tf32, 1/2 for
// bf16; the FMA variant's 3 FMAs and an add instead), and one MUFU
// rsqrt, whose 16 a clock an SM set a floor of about 1.03 ms at n = 65536.
// Issue, not the tensor cores, sets the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "forces.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 2;                  // m16 tiles a warp
constexpr int BM = WARPS * MT * 16;    // rows a block
constexpr int TJ = 128;                // sources a tile
static_assert(BM == TJ, "the diagonal is one tile of the block");
constexpr int STAGES = 3;              // raw tiles in flight
constexpr int BT = TJ + 4;             // tf32 B row stride: g*4 + t banks
constexpr int BB = TJ / 2 + 4;         // bf16 B row stride (in pairs)

struct Raw {             // one tile of sources as they are in memory
    float q[3 * TJ];
    float gm[TJ];
};

// How a variant accumulates W x [qj | 1]: one bf16 mma (default), two tf32
// mma on split operands (highest), or float32 FMAs on the CUDA cores
// (highest, where the tensor cores miss the tolerance: see the header)
enum class Accum { kBf16, kTf32Split, kFma };

struct Operands {        // one tile of derived operands
    float4 gram[TJ];     // Gram operand (x, y, z), |qj|^2 + eps2
    float4 src[TJ];      // kFma: the float32 source (x, y, z), unused w
    float gm[TJ];
    // the mma's B fragment source S[j][c], component-major. tf32:
    // [hi(x, y, z, 1) | lo(x, y, z, 1)], each value rounded to tf32 and its
    // remainder rounded again; bf16: [x, y, z, 1, 0, 0, 0, 0] in pairs of
    // sources (2p, 2p+1), low half 2p, rows 4..7 staying 0
    uint32_t bt[8][BT];
    uint32_t bb[8][BB];
};

__device__ __forceinline__ float bf16_rn(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded to tf32 (10 fraction bits), to nearest with ties to even; the
// low 13 bits of the result are 0. cvt.rn.tf32.f32 (sm_90) is one
// F2FP.TF32 instruction, where cvt.rna compiles to a sequence of compares,
// selects and integer ops.
__device__ __forceinline__ uint32_t tf32_rn(float x) {
    uint32_t r;
    asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ float as_float(uint32_t u) {
    return __uint_as_float(u);
}

// d2 < lo ? lo : d2 in one instruction; a NaN d2 passes, as in
// torch.clamp and jnp.maximum.
__device__ __forceinline__ float max_nan(float d2, float lo) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(d2), "f"(lo));
    return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &v, sizeof(u));
    return u;
}

// d = A (16x8 tf32) * B (8x8 tf32) + c, fragments as in the PTX ISA.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = A (16x16 bf16) * B (16x8 bf16), from 0.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
}

// The rows of one thread: (mt, h) is row warp*MT*16 + mt*16 + h*8 + g of the
// block, with its Gram operand and |qi|^2.
struct Rows {
    float gx[MT][2], gy[MT][2], gz[MT][2], n2[MT][2];
};

// w of one pair, op for op as accel_mxu_ref: the Gram, d2, the clamp,
// rsqrt, w.
__device__ __forceinline__ float pair_w(const Rows& rw, int mt, int h,
                                        float4 o, float m, float d2_min) {
    const float g = (rw.gx[mt][h] * o.x + rw.gy[mt][h] * o.y)
                    + rw.gz[mt][h] * o.z;
    const float d2 = max_nan(__fmaf_rn(-2.0f, g, rw.n2[mt][h] + o.w), d2_min);
    const float inv = nbody::rsqrt_approx(d2);
    return m * ((inv * inv) * inv);
}

// Issue the cp.async copies of the raw tile at j0 (cols sources).
__device__ __forceinline__ void stage(Raw& r, const float* q, const float* gm,
                                      int j0, int cols) {
    const int t = threadIdx.x;
    for (int k = t; k < 3 * cols; k += THREADS)
        nbody::cp_async4(&r.q[k], q + 3 * static_cast<size_t>(j0) + k);
    for (int k = t; k < cols; k += THREADS)
        nbody::cp_async4(&r.gm[k], gm + j0 + k);
}

template <bool GRAM_BF16, Accum ACC>
__device__ __forceinline__ void derive_one(const Raw& r, Operands& op,
                                           int cols, float eps2, int t) {
    const bool live = t < cols;
    float x = 0.0f, y = 0.0f, z = 0.0f, m = 0.0f;
    if (live) {
        x = r.q[3 * t];
        y = r.q[3 * t + 1];
        z = r.q[3 * t + 2];
        m = r.gm[t];
    }
    const float nj2 = (x * x + y * y) + z * z;
    op.gram[t] = GRAM_BF16
        ? make_float4(bf16_rn(x), bf16_rn(y), bf16_rn(z), nj2 + eps2)
        : make_float4(x, y, z, nj2 + eps2);
    op.gm[t] = m;
    const float s[4] = {x, y, z, live ? 1.0f : 0.0f};
    if (ACC == Accum::kFma) {
        op.src[t] = make_float4(x, y, z, 0.0f);
    } else if (ACC == Accum::kBf16) {
        __nv_bfloat16* bb = reinterpret_cast<__nv_bfloat16*>(&op.bb[0][0]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
            bb[c * 2 * BB + t] = __float2bfloat16_rn(s[c]);
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const uint32_t hi = tf32_rn(s[c]);
            op.bt[c][t] = hi;
            op.bt[c + 4][t] = tf32_rn(s[c] - as_float(hi));
        }
    }
}

// Derive one tile's operands from its raw sources, a source a thread.
template <bool GRAM_BF16, Accum ACC>
__device__ __forceinline__ void derive(const Raw& r, Operands& op, int cols,
                                       float eps2) {
    for (int t = threadIdx.x; t < TJ; t += THREADS)
        derive_one<GRAM_BF16, ACC>(r, op, cols, eps2, t);
}

// Fold one tile into the thread's tile sums, tacc[mt] in C-fragment order.
template <Accum ACC, bool MASK>
__device__ __forceinline__ void fold_tile(const Operands& op, const Rows& rw,
                                          float (&tacc)[MT][4], int lrow0,
                                          float d2_min) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    // a source s is masked for row (mt, h) when s == lrow0 + mt*16 + h*8
    // (lrow0 = warp*MT*16 + g): the diagonal tile only
    if (ACC == Accum::kBf16) {
#pragma unroll 2
        for (int c = 0; c < TJ / 16; ++c) {
            const int s0 = c * 16 + 2 * t;   // sources s0, s0+1, s0+8, s0+9
            const int src[4] = {s0, s0 + 1, s0 + 8, s0 + 9};
            float4 o[4];
            float m[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                o[k] = op.gram[src[k]];
                m[k] = op.gm[src[k]];
            }
            const uint32_t b0 = op.bb[g][c * 8 + t];
            const uint32_t b1 = op.bb[g][c * 8 + t + 4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                float w[2][4];
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        w[h][k] = pair_w(rw, mt, h, o[k], m[k], d2_min);
                        if (MASK && src[k] == lrow0 + mt * 16 + h * 8)
                            w[h][k] = 0.0f;
                    }
                const uint32_t a[4] = {pack_bf16(w[0][0], w[0][1]),
                                       pack_bf16(w[1][0], w[1][1]),
                                       pack_bf16(w[0][2], w[0][3]),
                                       pack_bf16(w[1][2], w[1][3])};
                float d[4];
                mma_bf16(d, a, b0, b1);
#pragma unroll
                for (int k = 0; k < 4; ++k) tacc[mt][k] += d[k];
            }
        }
    } else if (ACC == Accum::kTf32Split) {
        const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
        for (int c = 0; c < TJ / 8; ++c) {
            const int src[2] = {c * 8 + t, c * 8 + t + 4};
            float4 o[2];
            float m[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                o[k] = op.gram[src[k]];
                m[k] = op.gm[src[k]];
            }
            const uint32_t b0 = op.bt[g][src[0]], b1 = op.bt[g][src[1]];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                float w[4];   // A-fragment order: (g,t) (g+8,t) (g,t+4) (g+8,t+4)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int h = k % 2, sk = k / 2;
                    w[k] = pair_w(rw, mt, h, o[sk], m[sk], d2_min);
                    if (MASK && src[sk] == lrow0 + mt * 16 + h * 8)
                        w[k] = 0.0f;
                }
                // w_lo is handed over unrounded: the mma reads its top 11
                // bits (truncation), which saves the rounding's two integer
                // ops a pair
                uint32_t hi[4], lo[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    hi[k] = tf32_rn(w[k]);
                    lo[k] = __float_as_uint(w[k] - as_float(hi[k]));
                }
                // columns 0..3 take w * qj_hi, 4..7 w * qj_lo
                float d[4];
                mma_tf32(d, lo, b0, b1, zero);
                mma_tf32(d, hi, b0, b1, d);
#pragma unroll
                for (int k = 0; k < 4; ++k) tacc[mt][k] += d[k];
            }
        }
        // the tile's sums: column c plus column c + 4, which lane t + 2
        // holds for lane t (t = 0, 1)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int k = 0; k < 4; ++k)
                tacc[mt][k] += __shfl_down_sync(0xffffffffu, tacc[mt][k], 2);
    } else {
        // the same pairs as kTf32Split (sources t, t+4 of each chunk of 8),
        // each lane folding its 32 sources of the tile with FMAs into
        // p[mt][h] = (x, y, z, w) sums; then the quad's four lanes add theirs
        float p[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int k = 0; k < 4; ++k) p[mt][h][k] = 0.0f;
#pragma unroll 2
        for (int c = 0; c < TJ / 8; ++c) {
            const int src[2] = {c * 8 + t, c * 8 + t + 4};
#pragma unroll
            for (int sk = 0; sk < 2; ++sk) {
                const float4 o = op.gram[src[sk]];
                const float4 x = op.src[src[sk]];
                const float m = op.gm[src[sk]];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float w = pair_w(rw, mt, h, o, m, d2_min);
                        if (MASK && src[sk] == lrow0 + mt * 16 + h * 8)
                            w = 0.0f;
                        p[mt][h][0] = __fmaf_rn(w, x.x, p[mt][h][0]);
                        p[mt][h][1] = __fmaf_rn(w, x.y, p[mt][h][1]);
                        p[mt][h][2] = __fmaf_rn(w, x.z, p[mt][h][2]);
                        p[mt][h][3] += w;
                    }
            }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    float v = p[mt][h][k];
                    v += __shfl_xor_sync(0xffffffffu, v, 1);
                    v += __shfl_xor_sync(0xffffffffu, v, 2);
                    p[mt][h][k] = v;
                }
        // into the C-fragment order: lane t holds columns 2t and 2t+1
        // (lanes t = 2, 3 hold columns 4..7, which the epilogue skips)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                tacc[mt][2 * h] += t == 0 ? p[mt][h][0] : p[mt][h][2];
                tacc[mt][2 * h + 1] += t == 0 ? p[mt][h][1] : p[mt][h][3];
            }
    }
}

template <bool GRAM_BF16, Accum ACC>
__global__ void __launch_bounds__(THREADS)
accel_mxu_kernel(const float* __restrict__ q, const float* __restrict__ gm,
                 float* __restrict__ a, int n, float eps2) {
    __shared__ Raw s_raw[STAGES];
    __shared__ Operands s_op[2];

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const long long i0 = static_cast<long long>(blockIdx.x) * BM;
    const int lrow0 = warp * MT * 16 + g;
    const int tiles = (n - 1) / TJ + 1;
    const float d2_min = 0.5f * eps2;

    // the bf16 B fragment's rows 4..7 are 0 in both buffers, for good
    for (int k = tid; k < 4 * BB; k += THREADS) {
        const int c = 4 + k / BB, j = k % BB;
        s_op[0].bb[c][j] = s_op[1].bb[c][j] = 0u;
    }

    Rows rw;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long i = i0 + lrow0 + mt * 16 + h * 8;
            float x = 0.0f, y = 0.0f, z = 0.0f;
            if (i < n) {
                x = q[i * 3];
                y = q[i * 3 + 1];
                z = q[i * 3 + 2];
            }
            rw.n2[mt][h] = (x * x + y * y) + z * z;
            rw.gx[mt][h] = GRAM_BF16 ? bf16_rn(x) : x;
            rw.gy[mt][h] = GRAM_BF16 ? bf16_rn(y) : y;
            rw.gz[mt][h] = GRAM_BF16 ? bf16_rn(z) : z;
        }
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][k] = 0.0f;

    auto cols_of = [n](int k) { return min(TJ, n - k * TJ); };
    stage(s_raw[0], q, gm, 0, cols_of(0));
    nbody::cp_async_commit();
    if (tiles > 1)
        stage(s_raw[1], q, gm, TJ, cols_of(1));
    nbody::cp_async_commit();
    nbody::cp_async_wait<1>();
    __syncthreads();
    derive<GRAM_BF16, ACC>(s_raw[0], s_op[0], cols_of(0), eps2);

    for (int k = 0; k < tiles; ++k) {
        if (k + 2 < tiles)
            stage(s_raw[(k + 2) % STAGES], q, gm, (k + 2) * TJ, cols_of(k + 2));
        nbody::cp_async_commit();
        nbody::cp_async_wait<1>();
        // tile k + 1's raw sources and tile k's operands are in; every
        // thread has folded tile k - 1, whose operand buffer is free
        __syncthreads();
        if (k + 1 < tiles)
            derive<GRAM_BF16, ACC>(s_raw[(k + 1) % STAGES],
                                   s_op[(k + 1) % 2], cols_of(k + 1), eps2);
        float tacc[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int c = 0; c < 4; ++c) tacc[mt][c] = 0.0f;
        if (k == static_cast<int>(blockIdx.x))
            fold_tile<ACC, true>(s_op[k % 2], rw, tacc, lrow0, d2_min);
        else
            fold_tile<ACC, false>(s_op[k % 2], rw, tacc, lrow0, d2_min);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][c] += tacc[mt][c];
    }

    // acc[mt] = (row g: cols 2t, 2t+1; row g+8: cols 2t, 2t+1); the
    // columns are x, y, z, Σw, so lanes t = 0 and t = 1 hold a row's sums
    const int quad1 = (lane & ~3) | 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const float sw[2] = {__shfl_sync(0xffffffffu, acc[mt][1], quad1),
                             __shfl_sync(0xffffffffu, acc[mt][3], quad1)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long i = i0 + lrow0 + mt * 16 + h * 8;
            if (i >= n || t > 1)
                continue;
            if (t == 0) {
                a[i * 3] = acc[mt][2 * h] - sw[h] * q[i * 3];
                a[i * 3 + 1] = acc[mt][2 * h + 1] - sw[h] * q[i * 3 + 1];
            } else {
                a[i * 3 + 2] = acc[mt][2 * h] - sw[h] * q[i * 3 + 2];
            }
        }
    }
}

template <bool GRAM_BF16, Accum ACC>
void launch(const float* q, const float* gm, float* a, int n, float eps2,
            cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((n - 1) / BM + 1);
    accel_mxu_kernel<GRAM_BF16, ACC>
        <<<blocks, THREADS, 0, stream>>>(q, gm, a, n, eps2);
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// without launching. n rides gridDim.x (ceil(n / BM) blocks) and the
// source loop inside each block; it must be at least 1. gram_bf16 and
// accum_bf16 select the default (1) or highest (0) variant of each product.
extern "C" int accel_mxu_launch(const float* q, const float* gm, float* a,
                                int n, float eps2, int gram_bf16,
                                int accum_bf16, void* stream) {
    if (n <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (gram_bf16 && accum_bf16)
        launch<true, Accum::kBf16>(q, gm, a, n, eps2, s);
    else if (gram_bf16)
        launch<true, Accum::kFma>(q, gm, a, n, eps2, s);
    else if (accum_bf16)
        launch<false, Accum::kBf16>(q, gm, a, n, eps2, s);
    else
        launch<false, Accum::kTf32Split>(q, gm, a, n, eps2, s);
    return static_cast<int>(cudaGetLastError());
}
