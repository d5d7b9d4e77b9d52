// K6: a dense layer with its epilogue fused, forward; K6b, its backward.
//
// Replaces the Pallas TPU kernels `_fwd_call` / `_fwd_kernel` (K6) and
// `_bwd_call` / `_bwd_kernel` (K6b) of mvuld_tpu/ops/fused_dense.py
// (`dense_act` / `dense_ln`):
//
//   z = x @ W + b                    fp32 sums of bf16 products
//   a = GELU_erf(z)  or  z           ACT
//   y = LN(a) * gamma + beta  or  a  LN, eps a runtime argument (1e-6)
//
// x [M, K] and W [K, N] row-major (the JAX layout) in x's type (bf16 or
// fp32), b, gamma, beta fp32 [N], y [M, N] in x's type. K6b recomputes z
// and backpropagates dy [M, N] (x's type) through the LayerNorm and the
// GELU:
//
//   zhat = (a - mean a) * rstd;  dgamma += dy*zhat;  dbeta += dy
//   d_a  = (dy*gamma - mean(dy*gamma) - zhat * mean(dy*gamma*zhat)) * rstd
//   dz   = d_a * GELU'(z)  (or d_a);  db += dz
//
// and writes dz in x's type (the Pallas kernel's `dz_ref` is in x's dtype)
// and the column sums db (dgamma, dbeta) of the fp32 values in fp32.
// dx = dz W^T and dW = x^T dz stay outside, as the JAX package leaves them
// to XLA.
//
// Design. The product is a pass of the tiled tensor-core GEMM core of
// gemm_mma.cuh (128 x 128 block tiles, 8 warps of 64 x 32, a three-stage
// `cp.async` ring of BK = 64 k-steps, `ldmatrix` + `mma.sync.m16n8k16`,
// fp32 sums; ragged M, K and N zero-filled by the copies) with the
// elementwise work fused into its epilogue:
//   K6, no LN:   one pass, y = act(acc + b) in x's type;
//   K6, LN:      a = act(acc + b) → fp32 scratch [M, N], then
//                `dense_ln_rows` (one warp per row) writes y;
//   K6b, no LN:  GELU: one pass recomputing z whose epilogue reads dy and
//                writes dz = dy * GELU'(z), with the per-row-tile column
//                partials of db; act none: dz = dy, so no product, and
//                `dense_dz_cols` copies dy and takes the partials of db;
//   K6b, LN:     z = acc + b → fp32 scratch; `dense_ln_stats` (one warp
//                per row) writes mu, rstd, mean(dy*gamma) and
//                mean(dy*gamma*zhat) per row; `dense_dz_cols` (a block of
//                8 rows x 128 columns walks a row group, each thread 4
//                columns) writes dz and adds db, dgamma, dbeta over its
//                group's rows in row order;
// then `sum_into` adds the partials in a fixed order. No atomics: two
// launches give the same bits. The row passes read a row once per
// statistic (from L1 or L2 after the first read) rather than hold it in
// registers, so N has no upper bound with LN either.
//
// fp32 x: x and W are split into two bf16 planes (`gemm::split` into the
// caller's scratch) and the P = 2 instantiation adds hi.hi + hi.lo + lo.hi
// per k-step: about 2^-17 of each product, without TF32.
//
// Bound: 2*M*K*N bf16 tensor-core operations at 989 TFLOP/s (three times
// that as three products with fp32 x), beside the bytes (x, W, y once;
// K6b also dy and dz). The fp32 scratch with LN crosses device memory once
// each way (8*M*N bytes, in the forward about a third of the operations'
// time at blockbench's K 2048 → N 512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "gemm_io.cuh"
#include "gemm_mma.cuh"

namespace {

using gemm::Operand;

constexpr int ROWS = 8;          // rows of a row-pass block, one a warp
constexpr int CW = 128;          // columns of a `dense_dz_cols` block, 4 a lane

template <bool GELU>
__device__ __forceinline__ float act(float z) {
  return GELU ? gelu_erf(z) : z;
}

// ------------------------------------------------------------ epilogues

// y = act(acc + b) in O: x's type (the output) or fp32 (the LN scratch).
// BWD only tags the backward's instantiation (z for `dense_ln_stats`), so that a
// profile tells the two directions apart.
template <typename O, bool GELU, bool BWD>
struct DenseEpi {
  static constexpr bool kColSums = false;
  const float* b;
  O* y;
  int ld;
  __device__ __forceinline__ float2 operator()(int r, int c, float v0,
                                               float v1) const {
    store_pair(y + (size_t)r * ld + c, act<GELU>(v0 + b[c]),
               act<GELU>(v1 + b[c + 1]));
    return make_float2(0.f, 0.f);
  }
};

// dz = dy * GELU'(acc + b) in x's type; its column sums (fp32) give db
template <typename T>
struct DenseDzEpi {
  static constexpr bool kColSums = true;
  const float* b;
  const T* dy;
  T* dz;
  int ld;
  float* col_part;
  __device__ __forceinline__ float2 operator()(int r, int c, float v0,
                                               float v1) const {
    const size_t e = (size_t)r * ld + c;
    const float2 d = load_pair(dy + e);
    v0 = d.x * gelu_grad(v0 + b[c]);
    v1 = d.y * gelu_grad(v1 + b[c + 1]);
    store_pair(dz + e, v0, v1);
    return make_float2(v0, v1);
  }
};

// ------------------------------------------------------------ row passes

// y = LN(a) * gamma + beta, one warp per row: the mean, the variance of
// the centred row, then the output, each a walk over the row
template <typename T>
__global__ void __launch_bounds__(ROWS * 32) dense_ln_rows(
    const float* __restrict__ a, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y, int M, int N,
    float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (r >= M) return;
  const float* ar = a + (size_t)r * N;
  float v[4], s = 0.f;
  for (int c = lane * 4; c < N; c += 128) {
    load4(ar + c, v);
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  const float mu = warp_sum(s) / N;
  float q = 0.f;
  for (int c = lane * 4; c < N; c += 128) {
    load4(ar + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v[e] - mu;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / N + eps);
  for (int c = lane * 4; c < N; c += 128) {
    load4(ar + c, v);
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = (v[e] - mu) * rstd * gamma[c + e] + beta[c + e];
    store4(y + (size_t)r * N + c, o);
  }
}

// The LayerNorm backward's row statistics of a = act(z), one warp per row:
// stats[r] = (mu, rstd, mean(dy*gamma), mean(dy*gamma*zhat))
template <typename T, bool GELU>
__global__ void __launch_bounds__(ROWS * 32) dense_ln_stats(
    const float* __restrict__ z, const float* __restrict__ gamma,
    const T* __restrict__ dy, float4* __restrict__ stats, int M, int N,
    float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (r >= M) return;
  const float* zr = z + (size_t)r * N;
  float v[4], s = 0.f;
  for (int c = lane * 4; c < N; c += 128) {
    load4(zr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) s += act<GELU>(v[e]);
  }
  const float mu = warp_sum(s) / N;
  float q = 0.f;
  for (int c = lane * 4; c < N; c += 128) {
    load4(zr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = act<GELU>(v[e]) - mu;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / N + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane * 4; c < N; c += 128) {
    float d[4];
    load4(zr + c, v);
    load4(dy + (size_t)r * N + c, d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dyg = d[e] * gamma[c + e];
      s1 += dyg;
      s2 += dyg * ((act<GELU>(v[e]) - mu) * rstd);
    }
  }
  const float m1 = warp_sum(s1) / N, m2 = warp_sum(s2) / N;
  if (lane == 0) stats[r] = make_float4(mu, rstd, m1, m2);
}

struct Cols {
  const float* z;          // [M][N] z (GELU or LN)
  const float4* stats;     // [M] `dense_ln_stats`' rows (LN)
  const float* gamma;      // (LN)
  float* col_part;         // [G][NV * N]: db (| dgamma | dbeta) per group
  int M, N, rows_per_group;
};

// dz of the rows of group blockIdx.y and columns [blockIdx.x * CW, ...):
// each warp takes every ROWS-th row, each lane 4 columns, adding its
// column terms in row order; the block adds its warps' sums in warp order
// into the group's partial. LN: the LayerNorm backward from the row
// statistics; otherwise dz = dy (act none) or dy * GELU'(z).
template <typename T, bool GELU, bool LN>
__global__ void __launch_bounds__(ROWS * 32) dense_dz_cols(
    Cols a, const T* __restrict__ dy, T* __restrict__ dz) {
  constexpr int NV = LN ? 3 : 1;   // db | dgamma | dbeta
  __shared__ float red[ROWS][NV][CW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = a.N, c0 = blockIdx.x * CW, c = c0 + lane * 4;
  float acc[NV][4];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[v][e] = 0.f;
  if (c < N) {
    float g[4];
    if (LN)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[e] = a.gamma[c + e];
    const int r_end = min(a.M, (int)(blockIdx.y + 1) * a.rows_per_group);
    for (int r = blockIdx.y * a.rows_per_group + warp; r < r_end; r += ROWS) {
      const size_t at = (size_t)r * N + c;
      float d[4], zv[4], o[4];
      load4(dy + at, d);
      if (GELU || LN) load4(a.z + at, zv);
      float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
      if (LN) st = a.stats[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = d[e];
        if (LN) {
          const float zh = (act<GELU>(zv[e]) - st.x) * st.y;
          acc[1][e] += d[e] * zh;
          acc[2][e] += d[e];
          t = (d[e] * g[e] - st.z - zh * st.w) * st.y;
        }
        if (GELU) t *= gelu_grad(zv[e]);
        acc[0][e] += t;
        o[e] = t;
      }
      store4(dz + at, o);
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][v][lane * 4 + e] = acc[v][e];
  __syncthreads();
  float* part = a.col_part + (size_t)blockIdx.y * NV * N;
  for (int l = threadIdx.x; l < NV * CW; l += ROWS * 32) {
    const int v = l / CW, cc = l % CW;
    if (c0 + cc >= N) continue;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < ROWS; ++w) t += red[w][v][cc];
    part[(size_t)v * N + c0 + cc] = t;
  }
}

// ------------------------------------------------------------ planning

// The caller's scratch, carved into the passes' buffers (256-byte
// aligned); with base 0 it measures the size.
struct Plan {
  __nv_bfloat16 *x_t, *w_t;   // fp32 operands as two bf16 planes
  float* z;                   // [M][N]: a (forward) or z (backward), LN
  float4* stats;              // [M] (backward, LN)
  float *part, *sum_tmp;      // column partials [S][NV * N], first-level sums
  int S, rows_per_group;      // partials; `dense_dz_cols`' rows per group
  bool product;               // whether the pass set runs x.W
  size_t bytes;
};

Plan make_plan(uintptr_t base, int M, int K, int N, int P, bool gelu,
               bool ln, bool bwd, int sms) {
  Plan q{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const uintptr_t at = base + off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t MN = (size_t)M * N;
  q.product = !bwd || ln || gelu;    // act none, no LN: dz = dy
  if (P == 2 && q.product) {
    q.x_t = reinterpret_cast<__nv_bfloat16*>(take(2 * (size_t)M * K * 2));
    q.w_t = reinterpret_cast<__nv_bfloat16*>(take(2 * (size_t)K * N * 2));
  }
  if (ln) q.z = reinterpret_cast<float*>(take(MN * 4));
  if (bwd) {
    const int nv = ln ? 3 : 1;
    if (ln || !gelu) {
      // enough (column tile, row group) blocks to fill the card four times
      const int tiles = (N + CW - 1) / CW;
      const int G = std::max(1, std::min((4 * sms + tiles - 1) / tiles,
                                         (M + ROWS - 1) / ROWS));
      q.rows_per_group = (M + G - 1) / G;
      q.S = (M + q.rows_per_group - 1) / q.rows_per_group;
    } else {
      q.S = (M + gemm::BM - 1) / gemm::BM;   // the GEMM's row tiles
    }
    if (ln) q.stats = reinterpret_cast<float4*>(take((size_t)M * 16));
    q.part = reinterpret_cast<float*>(take((size_t)q.S * nv * N * 4));
    q.sum_tmp = reinterpret_cast<float*>(
        take((size_t)(q.S + GROUP - 1) / GROUP * nv * N * 4));
  }
  q.bytes = off;
  return q;
}

struct Args {
  const void *x, *w, *b, *gamma, *beta;
  int M, K, N;
  bool ln;
  float eps;
  void* work;
  int sms;
};

// The product's operands x, W: as given (bf16), or split into the plan's
// planes (fp32).
template <int P>
int operands(const Args& a, const Plan& q, Operand& X, Operand& W,
             cudaStream_t s) {
  const size_t MK = (size_t)a.M * a.K, KN = (size_t)a.K * a.N;
  if (P == 1) {
    X = {static_cast<const __nv_bfloat16*>(a.x), 0, a.K};
    W = {static_cast<const __nv_bfloat16*>(a.w), 0, a.N};
    return 0;
  }
  X = {q.x_t, MK, a.K};
  W = {q.w_t, KN, a.N};
  int err = gemm::split(static_cast<const float*>(a.x), q.x_t, MK, s);
  if (err == 0) err = gemm::split(static_cast<const float*>(a.w), q.w_t, KN, s);
  return err;
}

unsigned row_blocks(int M) { return (unsigned)((M + ROWS - 1) / ROWS); }

template <typename T, bool GELU>
int forward(const Args& a, void* out, cudaStream_t s) {
  constexpr int P = sizeof(T) / 2;
  const Plan q = make_plan(reinterpret_cast<uintptr_t>(a.work), a.M, a.K,
                           a.N, P, GELU, a.ln, false, a.sms);
  const float* b = static_cast<const float*>(a.b);
  Operand X, W;
  int err = operands<P>(a, q, X, W, s);
  if (err != 0) return err;
  if (!a.ln)
    return gemm::run<P, false, false>(
        X, W, a.M, a.N, a.K, a.K,
        DenseEpi<T, GELU, false>{b, static_cast<T*>(out), a.N}, s);
  err = gemm::run<P, false, false>(X, W, a.M, a.N, a.K, a.K,
                                   DenseEpi<float, GELU, false>{b, q.z, a.N}, s);
  if (err != 0) return err;
  dense_ln_rows<T><<<row_blocks(a.M), ROWS * 32, 0, s>>>(
      q.z, static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
      static_cast<T*>(out), a.M, a.N, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool GELU>
int backward(const Args& a, const void* dy_, void* dz_, float* vecs,
             cudaStream_t s) {
  constexpr int P = sizeof(T) / 2;
  const int M = a.M, N = a.N;
  const Plan q = make_plan(reinterpret_cast<uintptr_t>(a.work), M, a.K, N, P,
                           GELU, a.ln, true, a.sms);
  const float* b = static_cast<const float*>(a.b);
  const float* gamma = static_cast<const float*>(a.gamma);
  const T* dy = static_cast<const T*>(dy_);
  T* dz = static_cast<T*>(dz_);
  Operand X, W;
  int err = q.product ? operands<P>(a, q, X, W, s) : 0;
  if (err != 0) return err;
  const dim3 cols((N + CW - 1) / CW, q.S);
  const Cols c{q.z, q.stats, gamma, q.part, M, N, q.rows_per_group};
  if (!a.ln && GELU) {
    err = gemm::run<P, false, false>(X, W, M, N, a.K, a.K,
                                     DenseDzEpi<T>{b, dy, dz, N, q.part}, s);
  } else if (!a.ln) {
    dense_dz_cols<T, false, false><<<cols, ROWS * 32, 0, s>>>(c, dy, dz);
    err = static_cast<int>(cudaGetLastError());
  } else {
    err = gemm::run<P, false, false>(X, W, M, N, a.K, a.K,
                                     DenseEpi<float, false, true>{b, q.z, N}, s);
    if (err != 0) return err;
    dense_ln_stats<T, GELU><<<row_blocks(M), ROWS * 32, 0, s>>>(
        q.z, gamma, dy, q.stats, M, N, a.eps);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    dense_dz_cols<T, GELU, true><<<cols, ROWS * 32, 0, s>>>(c, dy, dz);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
  return sum_into(q.part, vecs, q.S, (size_t)(a.ln ? 3 : 1) * N, q.sum_tmp, s);
}

// The GEMM core's grid holds at most 65535 row tiles.
bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0 ||
         (M + gemm::BM - 1) / gemm::BM > 65535;
}

}  // namespace

// Bytes of scratch a launch needs (`work`): with LN the fp32 [M, N] of a
// or z; for the backward the column partials (and with LN the row
// statistics); with fp32 x the split operands. sms: the card's
// multiprocessor count (sets the backward's row groups; unread otherwise).
extern "C" size_t dense_work_bytes(int M, int K, int N, int gelu, int ln,
                                   int fp32, int bwd, int sms) {
  return make_plan(0, M, K, N, fp32 ? 2 : 1, gelu != 0, ln != 0, bwd != 0,
                   sms).bytes;
}

// K6. x, W, out in x's type: fp32 when `fp32`, else bf16. gamma and beta
// are read only when ln is set.
extern "C" int dense_act_ln_fwd(const void* x, const void* w, const void* b,
                                const void* gamma, const void* beta, void* out,
                                int M, int K, int N, int gelu, int ln,
                                float eps, int fp32, void* work,
                                void* stream) {
  if (bad_shape(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, w, b, gamma, beta, M, K, N, ln != 0, eps, work, 0};
  if (fp32)
    return gelu ? forward<float, true>(a, out, s) : forward<float, false>(a, out, s);
  return gelu ? forward<__nv_bfloat16, true>(a, out, s)
              : forward<__nv_bfloat16, false>(a, out, s);
}

// K6b. x, W, dy, dz in x's type as K6; vecs [nvec, N] fp32 receives db (|
// dgamma | dbeta when ln), nvec = 3 with ln, else 1.
extern "C" int dense_act_ln_bwd(const void* x, const void* w, const void* b,
                                const void* gamma, const void* dy, void* dz,
                                void* vecs, int M, int K, int N, int gelu,
                                int ln, float eps, int fp32, void* work,
                                int sms, void* stream) {
  if (bad_shape(M, K, N) || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, w, b, gamma, nullptr, M, K, N, ln != 0, eps, work, sms};
  float* v = static_cast<float*>(vecs);
  if (fp32)
    return gelu ? backward<float, true>(a, dy, dz, v, s)
                : backward<float, false>(a, dy, dz, v, s);
  return gelu ? backward<__nv_bfloat16, true>(a, dy, dz, v, s)
              : backward<__nv_bfloat16, false>(a, dy, dz, v, s);
}
