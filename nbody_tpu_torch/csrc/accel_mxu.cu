// Kernel B3: all-pairs softened gravitational acceleration in float32, the
// Gram form of the JAX package's matrix-unit experiment.
//
// Replaces nbody_tpu/ops/pallas_forces.py::_accel_kernel_mxu (its wrappers
// pallas_accel_mxu and pallas_step_mxu). On the TPU both O(n^2) products ran
// on the matrix unit: the Gram product qi4 (TI, 4) x qj4^T (4, TJ) and the
// accumulation W (TI, TJ) x [qj | 1] (TJ, 4). Per pair, op for op:
//
//   g   = (xi*xj + yi*yj) + zi*zj        (the 4th components add 0*1)
//   d2  = (|qi|^2 + (|qj|^2 + eps2)) - 2*g;  d2 = max(d2, eps2/2)
//   inv = rsqrt(d2);  w = gm_j * ((inv*inv)*inv);  w = 0 where j == i
//   acc += w * [xj, yj, zj, 1]
//
// and the epilogue a_i = acc[:3] - acc[3] * qi, the identity
// sum_j w (qj - qi) = sum_j w qj - (sum_j w) qi. The norms come from the
// full float32 coordinates, as the TPU's vector unit computes them; |qj|^2
// + eps2 is staged once per source. The self pair must be masked: in the
// split form w_ii ~ gm/eps^3 lands in both sums and their float32 rounding
// does not cancel. It is masked by index; the TPU's one-diagonal-tile
// shortcut was a scheduling detail of its grid.
//
// Precision variants, gram:accum in {highest, default}. highest is plain
// float32 products, what the JAX package's Precision.HIGHEST holds the TPU
// kernel to. default is one bf16 pass of the matrix unit: the product's
// inputs are rounded to bfloat16 (to nearest, ties to even), the product of
// two bf16 values is exact in float32, and the sum is float32. For the Gram
// that rounds qi and qj; for the accumulation it rounds w and qj (1 is
// exact). The library is built with -fmad=false (for kernel B1), so every
// product and sum rounds on its own, as the plain version's do.
//
// Layout: q (n, 3), gm (n,) and a (n, 3), contiguous float32. A thread owns
// one row i and keeps its four sums in registers; a block owns THREADS rows.
// For each tile of TJ sources, in ascending order, the block stages two
// float4s a source in shared memory (the Gram operand with |qj|^2 + eps2,
// and the accumulation operand with gm), every thread folds the tile in
// ascending j, and the tile sums are added to the row's sums in ascending
// tile order, as in kernel B2. The last tile is folded only to its end, so
// any n works unpadded. There are no atomics: the result is bitwise the
// same from run to run.
//
// Bound: fp32 issue. A pair of highest:highest costs 20 FP32 instructions
// (5 in g, 3 in d2, the clamp, 3 in w, the mask's select, 7 in the
// accumulation) and one MUFU rsqrt, against B2's 18; default accumulation
// adds the conversion of w. Tensor cores (bf16 mma for default, split
// 3xbf16 or 3xTF32 for highest) are later work: K=4 in the Gram and N=4 in
// the accumulation fill a sliver of an mma tile, as they did of the MXU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // rows i per block, one per thread
constexpr int TJ = THREADS;   // sources j per tile, one staged per thread

// A product input of one bf16 pass: x rounded to bfloat16, ties to even.
__device__ __forceinline__ float bf16_rn(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool GRAM_BF16, bool ACCUM_BF16>
__global__ void __launch_bounds__(THREADS)
accel_mxu_kernel(const float* __restrict__ q, const float* __restrict__ gm,
                 float* __restrict__ a, int n, float eps2) {
    __shared__ float4 s_gram[TJ];  // Gram operand (x, y, z), |qj|^2 + eps2
    __shared__ float4 s_acc[TJ];   // accumulation operand (x, y, z), gm

    const int t = threadIdx.x;
    const int i = blockIdx.x * THREADS + t;
    float xi = 0.0f, yi = 0.0f, zi = 0.0f;
    if (i < n) {
        const size_t o = static_cast<size_t>(i) * 3;
        xi = q[o];
        yi = q[o + 1];
        zi = q[o + 2];
    }
    const float ni2 = (xi * xi + yi * yi) + zi * zi;
    const float gxi = GRAM_BF16 ? bf16_rn(xi) : xi;
    const float gyi = GRAM_BF16 ? bf16_rn(yi) : yi;
    const float gzi = GRAM_BF16 ? bf16_rn(zi) : zi;
    const float d2_min = 0.5f * eps2;
    float ax = 0.0f, ay = 0.0f, az = 0.0f, aw = 0.0f;

    for (int j0 = 0; j0 < n; j0 += TJ) {
        const int cols = min(TJ, n - j0);
        __syncthreads();  // every thread has folded the previous tile
        if (t < cols) {
            const size_t o = static_cast<size_t>(j0 + t) * 3;
            const float x = q[o], y = q[o + 1], z = q[o + 2];
            const float nj2 = (x * x + y * y) + z * z;
            s_gram[t] = GRAM_BF16
                ? make_float4(bf16_rn(x), bf16_rn(y), bf16_rn(z), nj2 + eps2)
                : make_float4(x, y, z, nj2 + eps2);
            s_acc[t] = ACCUM_BF16
                ? make_float4(bf16_rn(x), bf16_rn(y), bf16_rn(z), gm[j0 + t])
                : make_float4(x, y, z, gm[j0 + t]);
        }
        __syncthreads();

        float px = 0.0f, py = 0.0f, pz = 0.0f, pw = 0.0f;
#pragma unroll 8
        for (int jj = 0; jj < cols; ++jj) {
            const float4 sg = s_gram[jj];
            const float g = (gxi * sg.x + gyi * sg.y) + gzi * sg.z;
            float d2 = (ni2 + sg.w) - 2.0f * g;
            d2 = d2 < d2_min ? d2_min : d2;  // a NaN passes, as jnp.maximum
            const float inv = rsqrtf(d2);
            const float4 sa = s_acc[jj];
            float w = sa.w * ((inv * inv) * inv);
            w = (j0 + jj == i) ? 0.0f : w;
            if (ACCUM_BF16)
                w = bf16_rn(w);
            px += w * sa.x;
            py += w * sa.y;
            pz += w * sa.z;
            pw += w;
        }
        ax += px;
        ay += py;
        az += pz;
        aw += pw;
    }
    if (i < n) {
        const size_t o = static_cast<size_t>(i) * 3;
        a[o] = ax - aw * xi;
        a[o + 1] = ay - aw * yi;
        a[o + 2] = az - aw * zi;
    }
}

template <bool GRAM_BF16, bool ACCUM_BF16>
void launch(const float* q, const float* gm, float* a, int n, float eps2,
            cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>(n / THREADS)
                            + (n % THREADS != 0 ? 1u : 0u);
    accel_mxu_kernel<GRAM_BF16, ACCUM_BF16>
        <<<blocks, THREADS, 0, stream>>>(q, gm, a, n, eps2);
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// without launching. n rides gridDim.x (ceil(n / THREADS) blocks) and the
// source loop inside each block; it must be at least 1. gram_bf16 and
// accum_bf16 select the default (1) or highest (0) variant of each product.
extern "C" int accel_mxu_launch(const float* q, const float* gm, float* a,
                                int n, float eps2, int gram_bf16,
                                int accum_bf16, void* stream) {
    if (n <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (gram_bf16 && accum_bf16)
        launch<true, true>(q, gm, a, n, eps2, s);
    else if (gram_bf16)
        launch<true, false>(q, gm, a, n, eps2, s);
    else if (accum_bf16)
        launch<false, true>(q, gm, a, n, eps2, s);
    else
        launch<false, false>(q, gm, a, n, eps2, s);
    return static_cast<int>(cudaGetLastError());
}
