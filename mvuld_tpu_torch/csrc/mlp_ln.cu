// K3 and K4: fused MLP + LayerNorm, forward.
//
// Replaces the Pallas TPU kernels `_mlp_ln_fwd` / `_mlp_fwd_kernel` (K3,
// `mlp_ln`, SwinV2 block second half, eps 1e-6) and `_mlp_ln_res_fwd` /
// `_mlp_res_fwd_kernel` (K4, `mlp_ln_res`, RoBERTa layer MLP half with the
// residual, eps 1e-5) of mvuld_tpu/ops/fused_dense.py. One kernel, the
// residual a template parameter, eps a runtime one:
//
//   h = GELU_erf(x @ W1 + b1)  rounded to bf16
//   z = h @ W2 + b2 (+ x)       fp32
//   y = LN(z) * gamma + beta    written as bf16
//
// x [M, C] bf16, W1 [C, Hd] and W2 [Hd, C] bf16 row-major (the JAX layout),
// b1, b2, gamma, beta fp32.
//
// Design. One block per tile of TM = 32 rows of x; 8 warps. The x tile and
// an fp32 accumulator for z (TM x C, 96 KB at C = 768) stay in shared
// memory. The block loops over hidden chunks of HC = 128 columns: the
// chunk's h (TM x HC) is computed with tensor cores, GELU'd, rounded to bf16
// in shared memory, and multiplied into the z accumulator at once, so the
// [M, 4C] hidden never reaches device memory and a C = 512 or 768 hidden
// row block never has to fit whole. The epilogue adds b2 (and x), and one
// warp per row takes the LayerNorm. Products use nvcuda::wmma, bf16 16x16x16
// with fp32 accumulation: bf16 operands and fp32 sums, what the Pallas kernel
// computes with `preferred_element_type=f32`.
//
// Bound: 4*M*C*Hd bf16 tensor-core operations against 989 TFLOP/s, ahead of
// the bytes (x and y once, W1 and W2 once). This first version reads the
// weight fragments straight from global memory (L2-resident) and moves the
// z accumulator through shared memory once per chunk; it is right and
// simple, not fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TM = 32;       // rows of x per block
constexpr int HC = 128;      // hidden columns per chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

size_t smem_bytes(int C) {
  // x tile bf16 + z accumulator fp32 + h chunk fp32 + h chunk bf16
  return (size_t)TM * C * 2 + (size_t)TM * C * 4 + (size_t)TM * HC * 4 +
         (size_t)TM * HC * 2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool RES>
__global__ void __launch_bounds__(THREADS) mlp_ln_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    const float* __restrict__ beta, __nv_bfloat16* __restrict__ out, int M,
    int C, int Hd, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);       // [TM][C]
  float* zs = reinterpret_cast<float*>(smem + (size_t)TM * C * 2);   // [TM][C]
  float* hf = zs + (size_t)TM * C;                                   // [TM][HC]
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(hf + TM * HC);  // [TM][HC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * TM;

  for (int idx = tid; idx < TM * C; idx += THREADS) {
    const int m = m0 + idx / C;
    xs[idx] = m < M ? x[(size_t)m0 * C + idx] : __float2bfloat16(0.f);
    zs[idx] = 0.f;
  }
  __syncthreads();

  for (int h0 = 0; h0 < Hd; h0 += HC) {
    // h chunk = x tile @ W1[:, h0:h0+HC]
    for (int f = warp; f < (TM / 16) * (HC / 16); f += WARPS) {
      const int fm = f / (HC / 16), fn = f % (HC / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, xs + fm * 16 * C + k, C);
        wmma::load_matrix_sync(bm, w1 + (size_t)k * Hd + h0 + fn * 16, Hd);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(hf + fm * 16 * HC + fn * 16, acc, HC,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < TM * HC; idx += THREADS) {
      const float v = hf[idx] + b1[h0 + idx % HC];
      hs[idx] = __float2bfloat16(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
    }
    __syncthreads();
    // z tile += h chunk @ W2[h0:h0+HC, :]
    for (int f = warp; f < (TM / 16) * (C / 16); f += WARPS) {
      const int fm = f / (C / 16), fn = f % (C / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* zp = zs + fm * 16 * C + fn * 16;
      wmma::load_matrix_sync(acc, zp, C, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < HC; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, hs + fm * 16 * HC + k, HC);
        wmma::load_matrix_sync(bm, w2 + (size_t)(h0 + k) * C + fn * 16, C);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(zp, acc, C, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // epilogue: + b2 (+ x), LayerNorm over C; one warp per row
  for (int r = warp; r < TM; r += WARPS) {
    const int m = m0 + r;
    if (m >= M) continue;  // uniform across the warp
    float* zr = zs + (size_t)r * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) {
      float z = zr[c] + b2[c];
      if (RES) z += __bfloat162float(xs[(size_t)r * C + c]);
      zr[c] = z;
      sum += z;
    }
    const float mu = warp_sum(sum) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = zr[c] - mu;
      var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / C + eps);
    for (int c = lane; c < C; c += 32)
      out[(size_t)m * C + c] =
          __float2bfloat16((zr[c] - mu) * rstd * gamma[c] + beta[c]);
  }
}

template <bool RES>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* gamma, const void* beta, void* out,
           int M, int C, int Hd, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_ln_kernel<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + TM - 1) / TM);
  mlp_ln_kernel<RES><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out), M, C,
      Hd, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mlp_ln_fwd(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* gamma,
                          const void* beta, void* out, int M, int C, int Hd,
                          int residual, float eps, void* stream) {
  if (C % 16 != 0 || Hd % HC != 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return residual ? launch<true>(x, w1, b1, w2, b2, gamma, beta, out, M, C, Hd, eps, s)
                  : launch<false>(x, w1, b1, w2, b2, gamma, beta, out, M, C, Hd, eps, s);
}
