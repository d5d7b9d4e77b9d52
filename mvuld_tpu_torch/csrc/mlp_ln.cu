// K3 and K4: fused MLP + LayerNorm, forward; K3b and K4b, their backward.
//
// Replaces the Pallas TPU kernels `_mlp_ln_fwd` / `_mlp_fwd_kernel` (K3,
// `mlp_ln`, SwinV2 block second half, eps 1e-6), `_mlp_ln_bwd` /
// `_mlp_bwd_kernel` (K3b), `_mlp_ln_res_fwd` / `_mlp_res_fwd_kernel` (K4,
// `mlp_ln_res`, RoBERTa layer MLP half with the residual, eps 1e-5) and
// `_mlp_ln_res_bwd` / `_mlp_res_bwd_kernel` (K4b) of
// mvuld_tpu/ops/fused_dense.py. One set of passes; the residual and the
// I/O type (bf16 or fp32, the type of x) are template parameters, eps a
// runtime one:
//
//   h = GELU_erf(x @ W1 + b1)    rounded to x's type
//   z = h @ W2 + b2               fp32
//   z = z * mask / keep (+ x)     K4: {0,1} dropout keep-mask, then residual
//   y = LN(z) * gamma + beta      written in x's type
//
// x [M, C] and W1 [C, Hd], W2 [Hd, C] row-major (the JAX layout) in x's
// type, b1, b2, gamma, beta fp32; the mask bf16 ({0,1} is exact).
//
// Design. Each product is a pass of the tiled tensor-core GEMM core of
// gemm_mma.cuh (128 x 128 block tiles, a `cp.async` ring of k-steps,
// `ldmatrix` + `mma.sync.m16n8k16`, fp32 sums) with its elementwise work
// fused into the epilogue, and the LayerNorm is a row pass, one warp per
// row. The forward runs three passes:
//   1. h = GELU(x.W1 + b1) → device memory in x's type;
//   2. z = (h.W2 + b2) * mask / keep (+ x) → device memory, fp32;
//   3. the LayerNorm of each row of z → y.
// Unlike the Pallas kernel, which keeps the [M, Hd] hidden in VMEM, the
// hidden crosses device memory once each way (M*Hd*2 bytes in bf16): a
// block tile of 128 rows reads each weight tile once per 128 rows, where
// keeping the hidden on chip would cap the row tile at a few dozen rows.
// The backward (K3b/K4b) recomputes h and z and runs:
//   1. h_pre = x.W1 + b1 kept fp32 (for GELU'), h = GELU(h_pre) in x's type;
//   2. z as the forward;
//   3. row pass: zhat, rstd, dz = (dy*g - mean(dy*g) - zhat *
//      mean(dy*g*zhat)) * rstd; dzm = dz * mask / keep written as dzb in
//      x's type; dz kept fp32 in place of z (K4b's residual gradient);
//      column partials of db2 = sum dzm, dgamma = sum dy*zhat, dbeta = sum dy
//      per row group;
//   4. dW2 = h^T.dzb (row groups of M, partials summed in a fixed order);
//   5. dh = dzb.W2^T, epilogue * GELU'(h_pre) → dhb in x's type over h's
//      memory (h is dead once dW2 has it), column partials of db1 per row
//      tile;
//   6. dx = dhb.W1^T (+ dz for K4b) in x's type;
//   7. dW1 = x^T.dhb as dW2; `sum_partials` adds every partial in a fixed
//      order. No atomics: every launch gives the same bits.
// The roundings of h, dzm and dh_pre to x's type before their products are
// the Pallas kernel's. With fp32 x every operand is split into two bf16
// terms (gemm_mma.cuh: three products per step), so the products keep fp32
// accuracy (about 2^-17 of each) without TF32.
//
// Bound: 4*M*C*Hd (forward) and 12*M*C*Hd (backward) bf16 tensor-core
// operations at 989 TFLOP/s, ahead of the bytes either way (the hidden's
// round trip included: 4*M*Hd bytes in the forward, about 18*M*Hd in the
// backward, 0.2-0.6 of the operations' time at C 768).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "gemm_io.cuh"
#include "gemm_mma.cuh"

namespace {

using gemm::Operand;

constexpr int ROW_WARPS = 8;     // rows per row-pass block, one a warp
constexpr int VMAX = 8;          // 4-value chunks a lane holds: C ≤ 1024

// (a, b) as P bf16 planes: hi, and with P = 2 lo = bf16(value - hi)
template <int P>
__device__ __forceinline__ void store_terms2(__nv_bfloat16* p, size_t plane,
                                             float a, float b) {
  const uint32_t hi = pack2(a, b);
  *reinterpret_cast<uint32_t*>(p) = hi;
  if (P == 2)
    *reinterpret_cast<uint32_t*>(p + plane) = pack2(a - low_f(hi), b - high_f(hi));
}
template <int P>
__device__ __forceinline__ void store_terms4(__nv_bfloat16* p, size_t plane,
                                             const float (&v)[4]) {
  const uint2 hi = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  *reinterpret_cast<uint2*>(p) = hi;
  if (P == 2)
    *reinterpret_cast<uint2*>(p + plane) =
        make_uint2(pack2(v[0] - low_f(hi.x), v[1] - high_f(hi.x)),
                   pack2(v[2] - low_f(hi.y), v[3] - high_f(hi.y)));
}

// ------------------------------------------------------------ epilogues

// h = GELU(acc + b1) as terms; BWD keeps h_pre = acc + b1 (fp32)
template <int P, bool BWD>
struct HiddenEpi {
  static constexpr bool kColSums = false;
  const float* b1;
  __nv_bfloat16* h;
  size_t plane;
  float* h_pre;
  int ld;
  __device__ __forceinline__ float2 operator()(int r, int c, float v0,
                                               float v1) const {
    v0 += b1[c];
    v1 += b1[c + 1];
    const size_t e = (size_t)r * ld + c;
    store_terms2<P>(h + e, plane, gelu_erf(v0), gelu_erf(v1));
    if (BWD) store_pair(h_pre + e, v0, v1);
    return make_float2(0.f, 0.f);
  }
};

// z = (acc + b2) * mask / keep (+ x), fp32. BWD only tags the backward's
// instantiation, so that a profile tells the two directions apart.
template <typename T, bool RES, bool BWD>
struct ZEpi {
  static constexpr bool kColSums = false;
  const float* b2;
  const __nv_bfloat16* mask;
  float inv_keep;
  const T* x;
  float* z;
  int ld;
  __device__ __forceinline__ float2 operator()(int r, int c, float v0,
                                               float v1) const {
    const size_t e = (size_t)r * ld + c;
    v0 += b2[c];
    v1 += b2[c + 1];
    if (mask != nullptr) {
      const float2 m = load_pair(mask + e);
      v0 *= m.x * inv_keep;
      v1 *= m.y * inv_keep;
    }
    if (RES) {
      const float2 xv = load_pair(x + e);
      v0 += xv.x;
      v1 += xv.y;
    }
    store_pair(z + e, v0, v1);
    return make_float2(0.f, 0.f);
  }
};

// dh_pre = acc * GELU'(h_pre) as terms; its column sums give db1
template <int P>
struct DhEpi {
  static constexpr bool kColSums = true;
  const float* h_pre;
  __nv_bfloat16* dh;
  size_t plane;
  int ld;
  float* col_part;
  __device__ __forceinline__ float2 operator()(int r, int c, float v0,
                                               float v1) const {
    const size_t e = (size_t)r * ld + c;
    const float2 hp = load_pair(h_pre + e);
    v0 *= gelu_grad(hp.x);
    v1 *= gelu_grad(hp.y);
    store_terms2<P>(dh + e, plane, v0, v1);
    return make_float2(v0, v1);
  }
};

// dx = acc (+ dz) in x's type
template <typename T, bool RES>
struct DxEpi {
  static constexpr bool kColSums = false;
  const float* dz;
  T* dx;
  int ld;
  __device__ __forceinline__ float2 operator()(int r, int c, float v0,
                                               float v1) const {
    const size_t e = (size_t)r * ld + c;
    if (RES) {
      const float2 d = load_pair(dz + e);
      v0 += d.x;
      v1 += d.y;
    }
    store_pair(dx + e, v0, v1);
    return make_float2(0.f, 0.f);
  }
};

// out[blockIdx.z] = acc, fp32: a weight gradient, or its row group's part
struct PartEpi {
  static constexpr bool kColSums = false;
  float* out;
  int ld;
  size_t part;
  __device__ __forceinline__ float2 operator()(int r, int c, float v0,
                                               float v1) const {
    store_pair(out + blockIdx.z * part + (size_t)r * ld + c, v0, v1);
    return make_float2(0.f, 0.f);
  }
};

// ------------------------------------------------------------ row passes

// y = LN(z) * gamma + beta, one warp per row
template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32) ln_rows_fwd(
    const float* __restrict__ z, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y, int M, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= M) return;
  const float* zr = z + (size_t)r * C;
  float v[VMAX][4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VMAX; ++i) {
    const int c = (i * 32 + lane) * 4;
    if (c < C) {
      load4(zr + c, v[i]);
      s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
    }
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VMAX; ++i)
    if ((i * 32 + lane) * 4 < C)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[i][e] - mu;
        q += d * d;
      }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < VMAX; ++i) {
    const int c = (i * 32 + lane) * 4;
    if (c < C) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = (v[i][e] - mu) * rstd * gamma[c + e] + beta[c + e];
      store4(y + (size_t)r * C + c, o);
    }
  }
}

struct RowsBwd {
  const float* gamma;
  const __nv_bfloat16* mask;
  float inv_keep;
  float* z;               // [M][C]: z in; dz out (K4b's residual gradient)
  __nv_bfloat16* dzb;     // [P][M][C]: dz * mask / keep as terms
  size_t plane;
  float* col_part;        // [G][3C]: db2 | dgamma | dbeta per row group
  int M, C, rows_per_block;
  float eps;
};

// The LayerNorm backward of rows [blockIdx.x * rows_per_block, ...), one
// warp per row; each warp adds its rows' column terms, in row order, into
// its own slice of shared memory, and the block adds the slices in warp
// order into its partial.
template <typename T, bool RES>
__global__ void __launch_bounds__(ROW_WARPS * 32) ln_rows_bwd(
    RowsBwd a, const T* __restrict__ dy) {
  constexpr int P = sizeof(T) / 2;
  extern __shared__ float red[];                  // [ROW_WARPS][3C]
  const int C = a.C, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = red + (size_t)warp * 3 * C;       // db2 | dgamma | dbeta
  for (int l = lane; l < 3 * C; l += 32) mine[l] = 0.f;
  __syncwarp();
  const int r_end = min(a.M, (blockIdx.x + 1) * a.rows_per_block);
  for (int r = blockIdx.x * a.rows_per_block + warp; r < r_end; r += ROW_WARPS) {
    float* zr = a.z + (size_t)r * C;
    float v[VMAX][4], d[VMAX][4];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VMAX; ++i) {
      const int c = (i * 32 + lane) * 4;
      if (c < C) {
        load4(zr + c, v[i]);
        load4(dy + (size_t)r * C + c, d[i]);
        s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
      }
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < VMAX; ++i)
      if ((i * 32 + lane) * 4 < C)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dd = v[i][e] - mu;
          q += dd * dd;
        }
    const float rstd = rsqrtf(warp_sum(q) / C + a.eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VMAX; ++i) {
      const int c = (i * 32 + lane) * 4;
      if (c < C)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[i][e] = (v[i][e] - mu) * rstd;                  // zhat
          const float dyg = d[i][e] * a.gamma[c + e];
          s1 += dyg;
          s2 += dyg * v[i][e];
          mine[C + c + e] += d[i][e] * v[i][e];
          mine[2 * C + c + e] += d[i][e];
        }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < VMAX; ++i) {
      const int c = (i * 32 + lane) * 4;
      if (c >= C) continue;
      float dz[4], dzm[4], m[4] = {1.f, 1.f, 1.f, 1.f};
      if (a.mask != nullptr) load4(a.mask + (size_t)r * C + c, m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dz[e] = (d[i][e] * a.gamma[c + e] - m1 - v[i][e] * m2) * rstd;
        dzm[e] = a.mask != nullptr ? dz[e] * (m[e] * a.inv_keep) : dz[e];
        mine[c + e] += dzm[e];
      }
      store_terms4<P>(a.dzb + (size_t)r * C + c, a.plane, dzm);
      if (RES) store4(zr + c, dz);
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < 3 * C; l += ROW_WARPS * 32) {
    float t = 0.f;
    for (int w = 0; w < ROW_WARPS; ++w) t += red[(size_t)w * 3 * C + l];
    a.col_part[(size_t)blockIdx.x * 3 * C + l] = t;
  }
}

// ------------------------------------------------------------ planning

// The caller's scratch, carved into the passes' buffers (256-byte
// aligned); with base 0 it measures the size.
struct Plan {
  __nv_bfloat16 *x_t, *w1_t, *w2_t;   // fp32 operands as two bf16 planes
  __nv_bfloat16 *h, *dzb;             // [P][M][Hd] (h, then dhb), [P][M][C]
  float *z, *h_pre, *db1_part, *col_part, *w_part;
  float* sum_tmp;                     // the first level of two-level sums
  int G, rows_per_block;              // row groups of the LN backward
  int S, k_split;                     // row groups of the weight gradients
  size_t bytes;
};

Plan make_plan(uintptr_t base, int M, int C, int Hd, int P, bool bwd, int sms) {
  Plan q{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const uintptr_t at = base + off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t MC = (size_t)M * C, MH = (size_t)M * Hd, CH = (size_t)C * Hd;
  if (P == 2) {
    q.x_t = reinterpret_cast<__nv_bfloat16*>(take(2 * MC * 2));
    q.w1_t = reinterpret_cast<__nv_bfloat16*>(take(2 * CH * 2));
    q.w2_t = reinterpret_cast<__nv_bfloat16*>(take(2 * CH * 2));
  }
  q.h = reinterpret_cast<__nv_bfloat16*>(take(P * MH * 2));
  q.z = reinterpret_cast<float*>(take(MC * 4));
  if (bwd) {
    q.h_pre = reinterpret_cast<float*>(take(MH * 4));
    q.dzb = reinterpret_cast<__nv_bfloat16*>(take(P * MC * 2));
    const int mt = (M + gemm::BM - 1) / gemm::BM;
    q.db1_part = reinterpret_cast<float*>(take((size_t)mt * Hd * 4));
    q.G = std::max(1, std::min((M + ROW_WARPS - 1) / ROW_WARPS, 2 * sms));
    q.rows_per_block = (M + q.G - 1) / q.G;
    q.G = (M + q.rows_per_block - 1) / q.rows_per_block;
    q.col_part = reinterpret_cast<float*>(take((size_t)q.G * 3 * C * 4));
    q.sum_tmp = reinterpret_cast<float*>(take(
        std::max((size_t)(mt + GROUP - 1) / GROUP * Hd,
                 (size_t)(q.G + GROUP - 1) / GROUP * 3 * C) * 4));
    // enough (tile, group) blocks to fill the card twice, groups of at
    // least 512 rows
    const int tiles = ((C + gemm::BN - 1) / gemm::BN) * ((Hd + gemm::BN - 1) / gemm::BN);
    const int S = std::max(1, std::min((2 * sms + tiles - 1) / tiles, M / 512));
    q.k_split = ((M + S - 1) / S + gemm::BK - 1) / gemm::BK * gemm::BK;
    q.S = (M + q.k_split - 1) / q.k_split;
    q.w_part = q.S > 1 ? reinterpret_cast<float*>(take((size_t)q.S * CH * 4)) : nullptr;
  }
  q.bytes = off;
  return q;
}

// dW [P x Q] = A^T B over the M rows (A [M][P], B [M][Q] as operands)
template <int PL>
int weight_grad(const Operand& A, const Operand& B, float* dw, const Plan& q,
                int M, int Pn, int Qn, cudaStream_t s) {
  const bool parts = q.S > 1;
  int err = gemm::run<PL, true, false>(
      A, B, Pn, Qn, M, q.k_split,
      PartEpi{parts ? q.w_part : dw, Qn, (size_t)Pn * Qn}, s);
  if (err != 0 || !parts) return err;
  return sum_into(q.w_part, dw, q.S, (size_t)Pn * Qn, nullptr, s);
}

struct Args {
  const void *x, *w1, *b1, *w2, *b2, *gamma, *beta, *mask;
  float keep;
  int M, C, Hd;
  float eps;
  void* work;
  int sms;
};

// The products' operands x, W1, W2: as given (bf16), or split into the
// plan's planes (fp32).
template <int P>
int operands(const Args& a, const Plan& q, Operand& X, Operand& W1,
             Operand& W2, cudaStream_t s) {
  const size_t MC = (size_t)a.M * a.C, CH = (size_t)a.C * a.Hd;
  if (P == 1) {
    X = {static_cast<const __nv_bfloat16*>(a.x), 0, a.C};
    W1 = {static_cast<const __nv_bfloat16*>(a.w1), 0, a.Hd};
    W2 = {static_cast<const __nv_bfloat16*>(a.w2), 0, a.C};
    return 0;
  }
  X = {q.x_t, MC, a.C};
  W1 = {q.w1_t, CH, a.Hd};
  W2 = {q.w2_t, CH, a.C};
  int err = gemm::split(static_cast<const float*>(a.x), q.x_t, MC, s);
  if (err == 0) err = gemm::split(static_cast<const float*>(a.w1), q.w1_t, CH, s);
  if (err == 0) err = gemm::split(static_cast<const float*>(a.w2), q.w2_t, CH, s);
  return err;
}

// h (and h_pre), then z: the two products both directions start with
template <typename T, bool RES, bool BWD>
int hidden_and_z(const Args& a, const Plan& q, const Operand& X,
                 const Operand& W1, const Operand& W2, cudaStream_t s) {
  constexpr int P = sizeof(T) / 2;
  const int M = a.M, C = a.C, Hd = a.Hd;
  const size_t MH = (size_t)M * Hd;
  int err = gemm::run<P, false, false>(
      X, W1, M, Hd, C, C,
      HiddenEpi<P, BWD>{static_cast<const float*>(a.b1), q.h, MH, q.h_pre, Hd}, s);
  if (err != 0) return err;
  const float inv_keep = 1.f / a.keep;
  return gemm::run<P, false, false>(
      Operand{q.h, MH, Hd}, W2, M, C, Hd, Hd,
      ZEpi<T, RES, BWD>{static_cast<const float*>(a.b2),
                   static_cast<const __nv_bfloat16*>(a.mask), inv_keep,
                   static_cast<const T*>(a.x), q.z, C},
      s);
}

template <typename T, bool RES>
int forward(const Args& a, void* out, cudaStream_t s) {
  constexpr int P = sizeof(T) / 2;
  const Plan q = make_plan(reinterpret_cast<uintptr_t>(a.work), a.M, a.C, a.Hd,
                           P, false, a.sms);
  Operand X, W1, W2;
  int err = operands<P>(a, q, X, W1, W2, s);
  if (err == 0) err = hidden_and_z<T, RES, false>(a, q, X, W1, W2, s);
  if (err != 0) return err;
  ln_rows_fwd<T><<<(a.M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(
      q.z, static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
      static_cast<T*>(out), a.M, a.C, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RES>
int backward(const Args& a, const void* dy, void* dx, float* dw1, float* dw2,
             float* dvec, cudaStream_t s) {
  constexpr int P = sizeof(T) / 2;
  const int M = a.M, C = a.C, Hd = a.Hd;
  const size_t MC = (size_t)M * C, MH = (size_t)M * Hd;
  const Plan q = make_plan(reinterpret_cast<uintptr_t>(a.work), M, C, Hd, P,
                           true, a.sms);
  Operand X, W1, W2;
  int err = operands<P>(a, q, X, W1, W2, s);
  if (err == 0) err = hidden_and_z<T, RES, true>(a, q, X, W1, W2, s);
  if (err != 0) return err;

  const size_t red = (size_t)ROW_WARPS * 3 * C * sizeof(float);
  cudaError_t ce = cudaFuncSetAttribute(
      ln_rows_bwd<T, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(red));
  if (ce != cudaSuccess) return static_cast<int>(ce);
  ln_rows_bwd<T, RES><<<q.G, ROW_WARPS * 32, red, s>>>(
      RowsBwd{static_cast<const float*>(a.gamma),
              static_cast<const __nv_bfloat16*>(a.mask), 1.f / a.keep, q.z,
              q.dzb, MC, q.col_part, M, C, q.rows_per_block, a.eps},
      static_cast<const T*>(dy));
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

  const Operand H{q.h, MH, Hd}, DZ{q.dzb, MC, C};
  // dW2 = h^T dzb [Hd, C]
  if ((err = weight_grad<P>(H, DZ, dw2, q, M, Hd, C, s)) != 0) return err;
  // dhb = (dzb W2^T) * GELU'(h_pre) over h; db1 partials per row tile
  err = gemm::run<P, false, true>(DZ, W2, M, Hd, C, C,
                                  DhEpi<P>{q.h_pre, q.h, MH, Hd, q.db1_part}, s);
  if (err != 0) return err;
  // dx = dhb W1^T (+ dz)
  err = gemm::run<P, false, true>(H, W1, M, C, Hd, Hd,
                                  DxEpi<T, RES>{q.z, static_cast<T*>(dx), C}, s);
  if (err != 0) return err;
  // dW1 = x^T dhb [C, Hd]
  if ((err = weight_grad<P>(X, H, dw1, q, M, C, Hd, s)) != 0) return err;
  const int mt = (M + gemm::BM - 1) / gemm::BM;
  if ((err = sum_into(q.db1_part, dvec, mt, Hd, q.sum_tmp, s)) != 0) return err;
  return sum_into(q.col_part, dvec + Hd, q.G, 3 * (size_t)C, q.sum_tmp, s);
}

bool bad_shape(int M, int C, int Hd) {
  return M <= 0 || C <= 0 || C % 16 != 0 || C > VMAX * 128 || Hd <= 0 ||
         Hd % 16 != 0;
}

}  // namespace

// Bytes of scratch a launch needs (`work`): the hidden, z, and for the
// backward h_pre, dzb and the partial sums; with fp32 x also the split
// operands. sms: the card's multiprocessor count (sets the row groups).
extern "C" size_t mlp_ln_work_bytes(int M, int C, int Hd, int fp32, int bwd,
                                    int sms) {
  return make_plan(0, M, C, Hd, fp32 ? 2 : 1, bwd != 0, sms).bytes;
}

// K3 / K4. x, W1, W2 and out in x's type (fp32 when `fp32`, else bf16).
extern "C" int mlp_ln_fwd(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* gamma,
                          const void* beta, const void* mask, float keep,
                          void* out, int M, int C, int Hd, int residual,
                          float eps, int fp32, void* work, int sms,
                          void* stream) {
  if (bad_shape(M, C, Hd) || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, w1, b1, w2, b2, gamma, beta, mask, keep, M, C, Hd, eps,
               work, sms};
  if (fp32)
    return residual ? forward<float, true>(a, out, s)
                    : forward<float, false>(a, out, s);
  return residual ? forward<__nv_bfloat16, true>(a, out, s)
                  : forward<__nv_bfloat16, false>(a, out, s);
}

// K3b / K4b. dy and dx in x's type; dW1 [C, Hd], dW2 [Hd, C] and dvec
// (db1 | db2 | dgamma | dbeta, Hd + 3C) fp32.
extern "C" int mlp_ln_bwd(const void* x, const void* dy, const void* mask,
                          float keep, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* gamma,
                          void* dx, void* dw1, void* dw2, void* dvec, int M,
                          int C, int Hd, int residual, float eps, int fp32,
                          void* work, int sms, void* stream) {
  if (bad_shape(M, C, Hd) || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, w1, b1, w2, b2, gamma, nullptr, mask, keep, M, C, Hd, eps,
               work, sms};
  float *g1 = static_cast<float*>(dw1), *g2 = static_cast<float*>(dw2),
        *gv = static_cast<float*>(dvec);
  if (fp32)
    return residual ? backward<float, true>(a, dy, dx, g1, g2, gv, s)
                    : backward<float, false>(a, dy, dx, g1, g2, gv, s);
  return residual ? backward<__nv_bfloat16, true>(a, dy, dx, g1, g2, gv, s)
                  : backward<__nv_bfloat16, false>(a, dy, dx, g1, g2, gv, s);
}
