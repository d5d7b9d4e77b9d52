// K3 and K4: fused MLP + LayerNorm, forward; K3b and K4b, their backward.
//
// Replaces the Pallas TPU kernels `_mlp_ln_fwd` / `_mlp_fwd_kernel` (K3,
// `mlp_ln`, SwinV2 block second half, eps 1e-6) and `_mlp_ln_res_fwd` /
// `_mlp_res_fwd_kernel` (K4, `mlp_ln_res`, RoBERTa layer MLP half with the
// residual, eps 1e-5) of mvuld_tpu/ops/fused_dense.py. One kernel, the
// residual a template parameter, eps a runtime one:
//
//   h = GELU_erf(x @ W1 + b1)  rounded to bf16
//   z = h @ W2 + b2              fp32
//   z = z * mask / keep (+ x)    K4: {0,1} dropout keep-mask, then residual
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

#include "common.cuh"

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

template <bool RES>
__global__ void __launch_bounds__(THREADS) mlp_ln_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    const float* __restrict__ beta, const __nv_bfloat16* __restrict__ mask,
    float keep, __nv_bfloat16* __restrict__ out, int M, int C, int Hd,
    float eps) {
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
      if (mask != nullptr) z *= __bfloat162float(mask[(size_t)m * C + c]) / keep;
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
           const void* b2, const void* gamma, const void* beta,
           const void* mask, float keep, void* out, int M, int C, int Hd,
           float eps, cudaStream_t stream) {
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
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(mask),
      keep, static_cast<__nv_bfloat16*>(out), M, C, Hd, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K3b/K4b
//
// Replace `_mlp_ln_bwd` / `_mlp_bwd_kernel` (K3b) and `_mlp_ln_res_bwd` /
// `_mlp_res_bwd_kernel` (K4b) of mvuld_tpu/ops/fused_dense.py. Per row:
//
//   recompute z (as the forward, mask and residual included), zhat, rstd
//   dz  = (dy*g - mean(dy*g) - zhat * mean(dy*g*zhat)) * rstd
//   dzm = dz * mask / keep (K4b) or dz;   dzb = bf16(dzm)
//   per hidden chunk: h_pre = x@W1 + b1;  hb = bf16(GELU(h_pre))
//                     dh = dzb @ W2^T;    dh_pre = dh * GELU'(h_pre)
//                     dhb = bf16(dh_pre); dx += dhb @ W1^T
//   dx (+ dz for K4b) written as bf16
//   db1 = sum dh_pre, db2 = sum dzm, dgamma = sum dy*zhat, dbeta = sum dy
//   dW1 = x^T dhb,  dW2 = hb^T dzb
//
// The bf16 roundings of dz and dh_pre before their products are the Pallas
// kernel's. Design: `bwd_rows` is persistent (a grid of G blocks walks the
// 16-row tiles); per tile it keeps x, dy, z/dz and the dx accumulator in
// shared memory and walks the hidden chunks as the forward does, so the
// [M, Hd] hidden is recomputed per tile and the products run on wmma bf16
// tensor cores with fp32 sums. The column sums (db1, db2, dgamma, dbeta)
// accumulate per block in shared memory in row order and leave as one
// partial per block. The weight gradients contract over all M rows: each
// tile hands its bf16 hb, dhb and dzb rows to `atb`, a wmma A^T.B kernel
// whose blocks each own a 64 x 64 output tile and one row group of M (S
// groups, sized to fill the card), so partials exist per row group only,
// never per tile; `sum_partials` reduces them in a fixed order. Every
// reduction is deterministic. Bound: 12*M*C*Hd bf16 tensor-core
// operations (the Pallas cost estimate) against 989 TFLOP/s; the hb/dhb
// round trip through device memory (4*M*Hd bytes) is the price of keeping
// the weight-gradient sums off atomics.

constexpr int BM = 16;        // rows per backward tile

struct BwdArgs {
  const __nv_bfloat16 *x, *dy, *mask;
  float keep;
  const __nv_bfloat16* w1;
  const float* b1;
  const __nv_bfloat16* w2;
  const float *b2, *gamma;
  __nv_bfloat16 *dx, *dzb, *hb, *dhb;
  float* col_part;
  int M, C, Hd;
  float eps;
};

size_t bwd_smem_bytes(int C, int Hd) {
  // xs, dys (bf16 [BM][C]); acc, dzs (fp32 [BM][C]); hf, dhf (fp32
  // [BM][HC]); hs, dhs (bf16 [BM][HC]); col (fp32 Hd + 3C); rstd (fp32 BM)
  return (size_t)BM * C * (2 + 2 + 4 + 4) + (size_t)BM * HC * (4 + 4 + 2 + 2) +
         ((size_t)Hd + 3 * C + BM) * 4;
}

template <bool RES>
__global__ void __launch_bounds__(THREADS) bwd_rows(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, Hd = a.Hd;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);     // [BM][C]
  __nv_bfloat16* dys = xs + (size_t)BM * C;                        // [BM][C]
  float* acc = reinterpret_cast<float*>(dys + (size_t)BM * C);     // [BM][C]
  float* dzs = acc + (size_t)BM * C;                               // [BM][C]
  float* hf = dzs + (size_t)BM * C;                                // [BM][HC]
  float* dhf = hf + BM * HC;                                       // [BM][HC]
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(dhf + BM * HC);
  __nv_bfloat16* dhs = hs + BM * HC;                               // [BM][HC]
  float* col = reinterpret_cast<float*>(dhs + BM * HC);  // db1|db2|dg|dbeta
  float* rstd = col + Hd + 3 * C;                                  // [BM]
  float* db2c = col + Hd;
  float* dgc = db2c + C;
  float* dbc = dgc + C;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int l = tid; l < Hd + 3 * C; l += THREADS) col[l] = 0.f;
  const int ntiles = (a.M + BM - 1) / BM;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = tile * BM;
    __syncthreads();
    for (int idx = tid; idx < BM * C; idx += THREADS) {
      const bool in = m0 + idx / C < a.M;
      xs[idx] = in ? a.x[(size_t)m0 * C + idx] : __float2bfloat16(0.f);
      dys[idx] = in ? a.dy[(size_t)m0 * C + idx] : __float2bfloat16(0.f);
      acc[idx] = 0.f;
    }
    __syncthreads();

    // z = GELU(x @ W1 + b1) @ W2, the forward's chunk walk
    for (int h0 = 0; h0 < Hd; h0 += HC) {
      {
        const int fn = warp;   // HC / 16 == WARPS column fragments
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
        wmma::fill_fragment(f, 0.f);
        for (int k = 0; k < C; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, xs + k, C);
          wmma::load_matrix_sync(fb, a.w1 + (size_t)k * Hd + h0 + fn * 16, Hd);
          wmma::mma_sync(f, fa, fb, f);
        }
        wmma::store_matrix_sync(hf + fn * 16, f, HC, wmma::mem_row_major);
      }
      __syncthreads();
      for (int idx = tid; idx < BM * HC; idx += THREADS)
        hs[idx] = __float2bfloat16(gelu_erf(hf[idx] + a.b1[h0 + idx % HC]));
      __syncthreads();
      for (int fn = warp; fn < C / 16; fn += WARPS) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
        wmma::load_matrix_sync(f, acc + fn * 16, C, wmma::mem_row_major);
#pragma unroll
        for (int k = 0; k < HC; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, hs + k, HC);
          wmma::load_matrix_sync(fb, a.w2 + (size_t)(h0 + k) * C + fn * 16, C);
          wmma::mma_sync(f, fa, fb, f);
        }
        wmma::store_matrix_sync(acc + fn * 16, f, C, wmma::mem_row_major);
      }
      __syncthreads();
    }

    // z (+ b2, mask, residual) → zhat in acc; rstd per row
    for (int r = warp; r < BM; r += WARPS) {
      const int m = m0 + r;
      float* zr = acc + (size_t)r * C;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) {
        float z = zr[c] + a.b2[c];
        if (a.mask != nullptr && m < a.M)
          z *= __bfloat162float(a.mask[(size_t)m * C + c]) / a.keep;
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
      const float rs = rsqrtf(warp_sum(var) / C + a.eps);
      for (int c = lane; c < C; c += 32) zr[c] = (zr[c] - mu) * rs;
      if (lane == 0) rstd[r] = rs;
    }
    __syncthreads();
    for (int c = tid; c < C; c += THREADS)     // dgamma, dbeta: row order
      for (int r = 0; r < BM; ++r) {
        const float d = __bfloat162float(dys[(size_t)r * C + c]);
        dgc[c] += d * acc[(size_t)r * C + c];
        dbc[c] += d;
      }
    __syncthreads();
    // LayerNorm backward → dz; dzm = dz·mask/keep into dzs and (bf16) dys;
    // acc becomes the dx accumulator: dz for K4b, 0 for K3b
    for (int r = warp; r < BM; r += WARPS) {
      const int m = m0 + r;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float dyg = __bfloat162float(dys[(size_t)r * C + c]) * a.gamma[c];
        s1 += dyg;
        s2 += dyg * acc[(size_t)r * C + c];
      }
      const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
      for (int c = lane; c < C; c += 32) {
        const size_t e = (size_t)r * C + c;
        const float dyg = __bfloat162float(dys[e]) * a.gamma[c];
        const float dz = (dyg - m1 - acc[e] * m2) * rstd[r];
        float dzm = dz;
        if (a.mask != nullptr && m < a.M)
          dzm *= __bfloat162float(a.mask[(size_t)m * C + c]) / a.keep;
        dzs[e] = dzm;
        const __nv_bfloat16 b = __float2bfloat16(dzm);
        dys[e] = b;
        a.dzb[(size_t)m * C + c] = b;
        acc[e] = RES ? dz : 0.f;
      }
    }
    __syncthreads();
    for (int c = tid; c < C; c += THREADS)     // db2: row order
      for (int r = 0; r < BM; ++r) db2c[c] += dzs[(size_t)r * C + c];

    for (int h0 = 0; h0 < Hd; h0 += HC) {
      __syncthreads();
      {
        const int fn = warp;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
        // h_pre chunk = x @ W1[:, h0:h0+HC]
        wmma::fill_fragment(f, 0.f);
        for (int k = 0; k < C; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, xs + k, C);
          wmma::load_matrix_sync(fb, a.w1 + (size_t)k * Hd + h0 + fn * 16, Hd);
          wmma::mma_sync(f, fa, fb, f);
        }
        wmma::store_matrix_sync(hf + fn * 16, f, HC, wmma::mem_row_major);
        // dh chunk = dzb @ W2[h0:h0+HC, :]^T
        wmma::fill_fragment(f, 0.f);
        for (int k = 0; k < C; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, dys + k, C);
          wmma::load_matrix_sync(fb, a.w2 + (size_t)(h0 + fn * 16) * C + k, C);
          wmma::mma_sync(f, fa, fb, f);
        }
        wmma::store_matrix_sync(dhf + fn * 16, f, HC, wmma::mem_row_major);
      }
      __syncthreads();
      for (int idx = tid; idx < BM * HC; idx += THREADS) {
        const int r = idx / HC, c = idx % HC;
        const float v = hf[idx] + a.b1[h0 + c];
        const float dhp = dhf[idx] * gelu_grad(v);
        const size_t e = (size_t)(m0 + r) * Hd + h0 + c;
        a.hb[e] = __float2bfloat16(gelu_erf(v));
        dhf[idx] = dhp;
        const __nv_bfloat16 b = __float2bfloat16(dhp);
        dhs[idx] = b;
        a.dhb[e] = b;
      }
      __syncthreads();
      for (int c = tid; c < HC; c += THREADS)    // db1: row order
        for (int r = 0; r < BM; ++r) col[h0 + c] += dhf[r * HC + c];
      // dx += dhb @ W1[:, h0:h0+HC]^T
      for (int fn = warp; fn < C / 16; fn += WARPS) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
        wmma::load_matrix_sync(f, acc + fn * 16, C, wmma::mem_row_major);
#pragma unroll
        for (int k = 0; k < HC; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, dhs + k, HC);
          wmma::load_matrix_sync(fb, a.w1 + (size_t)(fn * 16) * Hd + h0 + k, Hd);
          wmma::mma_sync(f, fa, fb, f);
        }
        wmma::store_matrix_sync(acc + fn * 16, f, C, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < BM * C; idx += THREADS)
      if (m0 + idx / C < a.M)
        a.dx[(size_t)m0 * C + idx] = __float2bfloat16(acc[idx]);
  }
  __syncthreads();
  float* part = a.col_part + (size_t)blockIdx.x * (Hd + 3 * C);
  for (int l = tid; l < Hd + 3 * C; l += THREADS) part[l] = col[l];
}

template <bool RES>
int launch_bwd_rows(const BwdArgs& a, int G, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(a.C, a.Hd);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_rows<RES><<<G, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out[S][P][Q] = A[rows of group s]^T . B[rows of group s]; A [M, P] and
// B [M, Q] bf16 row-major, M a multiple of 16. Block: one 64 x 64 output
// tile of one row group; warp w owns rows 16*(w/2) and two 16-column
// fragments.
__global__ void __launch_bounds__(THREADS) atb(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    float* __restrict__ out, int M, int P, int Q, int rows_per_split) {
  const int warp = threadIdx.x / 32;
  const int p = blockIdx.y * 64 + (warp / 2) * 16;
  const int q0 = blockIdx.x * 64 + (warp % 2) * 32;
  if (p >= P) return;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2];
  wmma::fill_fragment(f[0], 0.f);
  wmma::fill_fragment(f[1], 0.f);
  for (int m = m_begin; m < m_end; m += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
    wmma::load_matrix_sync(fa, A + (size_t)m * P + p, P);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (q0 + 16 * j >= Q) continue;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, B + (size_t)m * Q + q0 + 16 * j, Q);
      wmma::mma_sync(f[j], fa, fb, f[j]);
    }
  }
  float* o = out + (size_t)blockIdx.z * P * Q + (size_t)p * Q;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (q0 + 16 * j < Q)
      wmma::store_matrix_sync(o + q0 + 16 * j, f[j], Q, wmma::mem_row_major);
}

// dW = A^T B over Mp rows in S row groups; with S > 1 through wpart.
int weight_grad(const __nv_bfloat16* A, const __nv_bfloat16* B, float* dw,
                float* wpart, int Mp, int P, int Q, int S, int rows_per_split,
                cudaStream_t stream) {
  const dim3 grid((Q + 63) / 64, (P + 63) / 64, S);
  atb<<<grid, THREADS, 0, stream>>>(A, B, S > 1 ? wpart : dw, Mp, P, Q,
                                   rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const size_t L = (size_t)P * Q;
  sum_partials<<<(unsigned)((L + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      wpart, dw, S, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mlp_ln_fwd(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* gamma,
                          const void* beta, const void* mask, float keep,
                          void* out, int M, int C, int Hd, int residual,
                          float eps, void* stream) {
  if (C % 16 != 0 || Hd % HC != 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return residual ? launch<true>(x, w1, b1, w2, b2, gamma, beta, mask, keep,
                                 out, M, C, Hd, eps, s)
                  : launch<false>(x, w1, b1, w2, b2, gamma, beta, mask, keep,
                                  out, M, C, Hd, eps, s);
}

// K3b / K4b. Scratch from the caller: dzb [Mp, C], hb and dhb [Mp, Hd]
// (bf16, Mp = M rounded up to 16), col_part [G, Hd + 3C] and, when S > 1,
// wpart [S, C * Hd] (fp32). x must hold Mp rows (the rows past M zero).
// dvec receives db1 | db2 | dgamma | dbeta (fp32, Hd + 3C).
extern "C" int mlp_ln_bwd(const void* x, const void* dy, const void* mask,
                          float keep, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* gamma,
                          void* dx, void* dw1, void* dw2, void* dvec,
                          void* dzb, void* hb, void* dhb, void* col_part,
                          void* wpart, int M, int C, int Hd, int residual,
                          float eps, int G, int S, int rows_per_split,
                          void* stream) {
  if (C % 16 != 0 || Hd % HC != 0 || M <= 0 || G <= 0 || S <= 0 ||
      rows_per_split % BM != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(dy),
                  static_cast<const __nv_bfloat16*>(mask), keep,
                  static_cast<const __nv_bfloat16*>(w1),
                  static_cast<const float*>(b1),
                  static_cast<const __nv_bfloat16*>(w2),
                  static_cast<const float*>(b2),
                  static_cast<const float*>(gamma),
                  static_cast<__nv_bfloat16*>(dx),
                  static_cast<__nv_bfloat16*>(dzb),
                  static_cast<__nv_bfloat16*>(hb),
                  static_cast<__nv_bfloat16*>(dhb),
                  static_cast<float*>(col_part), M, C, Hd, eps};
  int err = residual ? launch_bwd_rows<true>(a, G, s)
                     : launch_bwd_rows<false>(a, G, s);
  if (err != 0) return err;
  const int Mp = (M + BM - 1) / BM * BM;
  const size_t L = (size_t)Hd + 3 * (size_t)C;
  sum_partials<<<(unsigned)((L + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(col_part), static_cast<float*>(dvec), G, L);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  // dW1 = x^T dhb [C, Hd]; dW2 = hb^T dzb [Hd, C]
  err = weight_grad(static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(dhb),
                    static_cast<float*>(dw1), static_cast<float*>(wpart), Mp,
                    C, Hd, S, rows_per_split, s);
  if (err != 0) return err;
  return weight_grad(static_cast<const __nv_bfloat16*>(hb),
                     static_cast<const __nv_bfloat16*>(dzb),
                     static_cast<float*>(dw2), static_cast<float*>(wpart), Mp,
                     Hd, C, S, rows_per_split, s);
}
