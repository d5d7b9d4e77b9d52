// K6: a dense layer with its epilogue fused, forward; K6b, its backward
// row pass.
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
// per row tile and backpropagates dy [M, N] (x's type) through the
// LayerNorm and the GELU:
//
//   zhat = (a - mean a) * rstd;  dgamma += dy*zhat;  dbeta += dy
//   d_a  = (dy*gamma - mean(dy*gamma) - zhat * mean(dy*gamma*zhat)) * rstd
//   dz   = d_a * GELU'(z)  (or d_a);  db += dz
//
// and writes dz in x's type (the Pallas kernel's `dz_ref` is in x's dtype)
// and the column sums db (dgamma, dbeta) in fp32. dx = dz W^T and dW = x^T
// dz stay outside, as the JAX package leaves them to XLA.
//
// fp32 x (P = 2 below): x and W are split into two bf16 terms, hi and lo =
// bf16(value - hi) (the x tile when it is staged, W by `split_terms` into
// the caller's scratch), and each k-step adds hi.hi + hi.lo + lo.hi: fp32
// sums within about 2^-17 of each product, without TF32. The bf16
// instantiation (P = 1) is the kernel as it was.
//
// Design. A block owns TM = 16 whole rows, so the LayerNorm's row
// statistics never cross blocks: the x tile (TM x K bf16, a plane per
// term) and the row's z
// (TM x N fp32, 128 KB at N = 2048) stay in shared memory. The block walks
// the output columns in chunks of HC = 128; each of its 8 warps owns one
// 16 x 16 wmma fragment of the chunk (bf16 16x16x16 products, fp32
// accumulators, W fragments read straight from global memory, where the
// [K, N] weight stays L2-resident across the row tiles) and the chunk goes
// through shared memory for the bias and the activation. Without LN a chunk
// is written out at once; with LN one warp per row takes the statistics
// once every chunk is in. K6b is persistent (a grid of G blocks walks the
// tiles) and keeps its column sums in shared memory, adding each tile's
// rows in row order; each block leaves one partial per column and
// `sum_partials` adds the G partials in block order. No atomics, so every
// sum is deterministic, and rows past M (the ragged last tile) are zero in
// x and skipped in every sum and store.
//
// Bound: 2*M*K*N bf16 tensor-core operations against 989 TFLOP/s, beside
// the bytes (x, W, y once; K6b also dy and dz). This first version is right
// and simple: every 16-row tile reads all of W again from L2 as wmma
// fragments, so it runs far from that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"
#include "gemm_mma.cuh"

using namespace nvcuda;

namespace {

constexpr int TM = 16;        // rows per tile
constexpr int HC = 128;       // output columns per chunk
constexpr int WARPS = 8;      // one 16-column fragment of the chunk each
constexpr int THREADS = WARPS * 32;

template <bool GELU>
__device__ __forceinline__ float act(float z) {
  return GELU ? gelu_erf(z) : z;
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
// fp32 → the I/O type. Used as an assignment's right side, which is
// evaluated before the address, so the bf16 stores keep that order.
template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float to_t<float>(float v) { return v; }

// zs[r][h0 + c] = (x tile @ W)[r][h0 + c] + b[h0 + c] for every chunk, or,
// with `direct`, act(...) written straight to `out` (rows < rows_valid).
// With P = 2, xs and w hold two term planes (TM * K and K * N apart).
template <bool GELU, typename T>
__device__ void tile_products(const __nv_bfloat16* xs,
                              const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ b, float* cf,
                              float* zs, T* out, int m0,
                              int rows_valid, int K, int N, bool direct) {
  constexpr int P = sizeof(T) / 2;
  const int tid = threadIdx.x, warp = tid / 32;
  for (int h0 = 0; h0 < N; h0 += HC) {
    const int nc = min(HC, N - h0);
    if (warp * 16 < nc) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, xs + k, K);
        wmma::load_matrix_sync(fb, w + (size_t)k * N + h0 + warp * 16, N);
        wmma::mma_sync(acc, fa, fb, acc);
        if constexpr (P == 2) {   // hi.lo + lo.hi
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa_lo;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb_lo;
          wmma::load_matrix_sync(fa_lo, xs + TM * K + k, K);
          wmma::load_matrix_sync(fb_lo, w + (size_t)K * N + (size_t)k * N + h0 + warp * 16, N);
          wmma::mma_sync(acc, fa, fb_lo, acc);
          wmma::mma_sync(acc, fa_lo, fb, acc);
        }
      }
      wmma::store_matrix_sync(cf + warp * 16, acc, HC, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < TM * nc; idx += THREADS) {
      const int r = idx / nc, c = idx % nc;
      const float z = cf[r * HC + c] + b[h0 + c];
      if (!direct)
        zs[(size_t)r * N + h0 + c] = z;
      else if (r < rows_valid)
        out[(size_t)(m0 + r) * N + h0 + c] = to_t<T>(act<GELU>(z));
    }
    __syncthreads();
  }
}

__device__ void load_x_tile(const __nv_bfloat16* __restrict__ x,
                            __nv_bfloat16* xs, int m0, int rows_valid,
                            int K) {
  for (int idx = threadIdx.x; idx < TM * K; idx += THREADS)
    xs[idx] = idx / K < rows_valid ? x[(size_t)m0 * K + idx]
                                   : __float2bfloat16(0.f);
}

// fp32 x: the tile as two planes, hi then lo
__device__ void load_x_tile(const float* __restrict__ x, __nv_bfloat16* xs,
                            int m0, int rows_valid, int K) {
  for (int idx = threadIdx.x; idx < TM * K; idx += THREADS) {
    const float v = idx / K < rows_valid ? x[(size_t)m0 * K + idx] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16(v);
    xs[idx] = hi;
    xs[TM * K + idx] = __float2bfloat16(v - __bfloat162float(hi));
  }
}

template <bool GELU, bool LN, typename T>
__global__ void __launch_bounds__(THREADS) dense_fwd(
    const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int M,
    int K, int N, float eps) {
  constexpr int P = sizeof(T) / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);          // [P][TM][K]
  float* cf = reinterpret_cast<float*>(smem + (size_t)P * TM * K * 2);  // [TM][HC]
  float* zs = cf + TM * HC;                                             // [TM][N]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * TM, rows = min(TM, M - m0);

  load_x_tile(x, xs, m0, rows, K);
  __syncthreads();
  tile_products<GELU>(xs, w, b, cf, zs, out, m0, rows, K, N, !LN);
  if (!LN) return;
  for (int r = warp; r < rows; r += WARPS) {   // LayerNorm, a warp per row
    float* zr = zs + (size_t)r * N;
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      zr[c] = act<GELU>(zr[c]);
      sum += zr[c];
    }
    const float mu = warp_sum(sum) / N;
    float var = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float d = zr[c] - mu;
      var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / N + eps);
    for (int c = lane; c < N; c += 32)
      out[(size_t)(m0 + r) * N + c] =
          to_t<T>((zr[c] - mu) * rstd * gamma[c] + beta[c]);
  }
}

template <bool GELU, bool LN, typename T>
__global__ void __launch_bounds__(THREADS) dense_bwd_rows(
    const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ gamma,
    const T* __restrict__ dy, T* __restrict__ dz,
    float* __restrict__ col_part, int M, int K, int N, float eps) {
  constexpr int NV = LN ? 3 : 1;   // db | dgamma | dbeta
  constexpr int P = sizeof(T) / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);          // [P][TM][K]
  float* cf = reinterpret_cast<float*>(smem + (size_t)P * TM * K * 2);  // [TM][HC]
  float* zs = cf + TM * HC;                                             // [TM][N]
  float* col = zs + (size_t)TM * N;                                     // [NV][N]
  float* stat = col + (size_t)NV * N;                 // [TM][4] mu rstd m1 m2
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int l = tid; l < NV * N; l += THREADS) col[l] = 0.f;
  const int ntiles = (M + TM - 1) / TM;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = tile * TM, rows = min(TM, M - m0);
    const T* dyt = dy + (size_t)m0 * N;
    __syncthreads();   // the previous tile's column pass is done
    load_x_tile(x, xs, m0, rows, K);
    __syncthreads();
    tile_products<GELU>(xs, w, b, cf, zs, static_cast<T*>(nullptr), m0, rows,
                        K, N, false);

    if (LN) {
      for (int r = warp; r < rows; r += WARPS) {   // row statistics
        const float* zr = zs + (size_t)r * N;
        float sum = 0.f;
        for (int c = lane; c < N; c += 32) sum += act<GELU>(zr[c]);
        const float mu = warp_sum(sum) / N;
        float var = 0.f;
        for (int c = lane; c < N; c += 32) {
          const float d = act<GELU>(zr[c]) - mu;
          var += d * d;
        }
        const float rstd = rsqrtf(warp_sum(var) / N + eps);
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < N; c += 32) {
          const float dyg = to_f(dyt[(size_t)r * N + c]) * gamma[c];
          s1 += dyg;
          s2 += dyg * (act<GELU>(zr[c]) - mu) * rstd;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          stat[r * 4] = mu;
          stat[r * 4 + 1] = rstd;
          stat[r * 4 + 2] = s1 / N;
          stat[r * 4 + 3] = s2 / N;
        }
      }
      __syncthreads();
      for (int c = tid; c < N; c += THREADS)       // dgamma, dbeta: row order
        for (int r = 0; r < rows; ++r) {
          const float d = to_f(dyt[(size_t)r * N + c]);
          const float zh = (act<GELU>(zs[(size_t)r * N + c]) - stat[r * 4]) *
                           stat[r * 4 + 1];
          col[N + c] += d * zh;
          col[2 * N + c] += d;
        }
      __syncthreads();
    }
    for (int r = warp; r < rows; r += WARPS) {     // dz, in place of z
      float* zr = zs + (size_t)r * N;
      for (int c = lane; c < N; c += 32) {
        const float z = zr[c];
        float d = to_f(dyt[(size_t)r * N + c]);
        if (LN) {
          const float* st = stat + r * 4;
          const float zh = (act<GELU>(z) - st[0]) * st[1];
          d = (d * gamma[c] - st[2] - zh * st[3]) * st[1];
        }
        if (GELU) d *= gelu_grad(z);
        zr[c] = d;
        dz[(size_t)(m0 + r) * N + c] = to_t<T>(d);
      }
    }
    __syncthreads();
    for (int c = tid; c < N; c += THREADS)         // db: row order
      for (int r = 0; r < rows; ++r) col[c] += zs[(size_t)r * N + c];
  }
  __syncthreads();
  float* part = col_part + (size_t)blockIdx.x * NV * N;
  for (int l = tid; l < NV * N; l += THREADS) part[l] = col[l];
}

size_t fwd_smem(int K, int N, bool ln, int P) {
  return (size_t)P * TM * K * 2 + (size_t)TM * HC * 4 +
         (ln ? (size_t)TM * N * 4 : 0);
}

size_t bwd_smem(int K, int N, bool ln, int P) {
  return (size_t)P * TM * K * 2 + (size_t)TM * HC * 4 + (size_t)TM * N * 4 +
         (size_t)(ln ? 3 : 1) * N * 4 + (size_t)TM * 4 * 4;
}

// W as the kernels read it: as given (bf16), or split into two bf16 planes
// in `w_terms` ([2][K][N]) for fp32 x.
template <typename T>
const __nv_bfloat16* weight_terms(const void* w, void* w_terms, int K, int N,
                                  cudaStream_t stream, int& err) {
  err = 0;
  if (sizeof(T) == 2) return static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* t = static_cast<__nv_bfloat16*>(w_terms);
  err = gemm::split(static_cast<const float*>(w), t, (size_t)K * N, stream);
  return t;
}

template <bool GELU, bool LN, typename T>
int launch_fwd(const void* x, const void* w, const void* b, const void* gamma,
               const void* beta, void* out, int M, int K, int N, float eps,
               void* w_terms, cudaStream_t stream) {
  const size_t smem = fwd_smem(K, N, LN, sizeof(T) / 2);
  int e = 0;
  const __nv_bfloat16* wt = weight_terms<T>(w, w_terms, K, N, stream, e);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      dense_fwd<GELU, LN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_fwd<GELU, LN, T><<<(M + TM - 1) / TM, THREADS, smem, stream>>>(
      static_cast<const T*>(x), wt, static_cast<const float*>(b),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(out), M, K, N, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool GELU, bool LN, typename T>
int launch_bwd(const void* x, const void* w, const void* b, const void* gamma,
               const void* dy, void* dz, void* vecs, void* col_part, int M,
               int K, int N, float eps, int G, void* w_terms,
               cudaStream_t stream) {
  const size_t smem = bwd_smem(K, N, LN, sizeof(T) / 2);
  int e = 0;
  const __nv_bfloat16* wt = weight_terms<T>(w, w_terms, K, N, stream, e);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      dense_bwd_rows<GELU, LN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_bwd_rows<GELU, LN, T><<<G, THREADS, smem, stream>>>(
      static_cast<const T*>(x), wt, static_cast<const float*>(b),
      static_cast<const float*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dz), static_cast<float*>(col_part), M, K, N, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t L = (size_t)(LN ? 3 : 1) * N;
  sum_partials<<<(unsigned)((L + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const float*>(col_part), static_cast<float*>(vecs), G, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_any(const void* x, const void* w, const void* b, const void* gamma,
            const void* beta, void* out, int M, int K, int N, int gelu, int ln,
            float eps, void* w_terms, cudaStream_t s) {
  if (gelu)
    return ln ? launch_fwd<true, true, T>(x, w, b, gamma, beta, out, M, K, N,
                                          eps, w_terms, s)
              : launch_fwd<true, false, T>(x, w, b, gamma, beta, out, M, K, N,
                                           eps, w_terms, s);
  return ln ? launch_fwd<false, true, T>(x, w, b, gamma, beta, out, M, K, N,
                                         eps, w_terms, s)
            : launch_fwd<false, false, T>(x, w, b, gamma, beta, out, M, K, N,
                                          eps, w_terms, s);
}

template <typename T>
int bwd_any(const void* x, const void* w, const void* b, const void* gamma,
            const void* dy, void* dz, void* vecs, void* col_part, int M, int K,
            int N, int gelu, int ln, float eps, int G, void* w_terms,
            cudaStream_t s) {
  if (gelu)
    return ln ? launch_bwd<true, true, T>(x, w, b, gamma, dy, dz, vecs,
                                          col_part, M, K, N, eps, G, w_terms, s)
              : launch_bwd<true, false, T>(x, w, b, gamma, dy, dz, vecs,
                                           col_part, M, K, N, eps, G, w_terms, s);
  return ln ? launch_bwd<false, true, T>(x, w, b, gamma, dy, dz, vecs, col_part,
                                         M, K, N, eps, G, w_terms, s)
            : launch_bwd<false, false, T>(x, w, b, gamma, dy, dz, vecs,
                                          col_part, M, K, N, eps, G, w_terms, s);
}

bool bad_shape(int M, int K, int N) {
  return M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0;
}

}  // namespace

// K6. x, W, out in x's type: fp32 when `fp32` (W then split into
// w_terms, [2][K][N] bf16), else bf16. gamma and beta are read only when
// ln is set.
extern "C" int dense_act_ln_fwd(const void* x, const void* w, const void* b,
                                const void* gamma, const void* beta, void* out,
                                int M, int K, int N, int gelu, int ln,
                                float eps, int fp32, void* w_terms,
                                void* stream) {
  if (bad_shape(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32 ? fwd_any<float>(x, w, b, gamma, beta, out, M, K, N, gelu, ln,
                               eps, w_terms, s)
              : fwd_any<__nv_bfloat16>(x, w, b, gamma, beta, out, M, K, N,
                                       gelu, ln, eps, w_terms, s);
}

// K6b. x, W, dy, dz in x's type as K6. Scratch: col_part [G, nvec * N]
// fp32 (and w_terms for fp32); vecs [nvec, N] fp32 receives db (| dgamma |
// dbeta when ln), nvec = 3 with ln, else 1.
extern "C" int dense_act_ln_bwd(const void* x, const void* w, const void* b,
                                const void* gamma, const void* dy, void* dz,
                                void* vecs, void* col_part, int M, int K,
                                int N, int gelu, int ln, float eps, int G,
                                int fp32, void* w_terms, void* stream) {
  if (bad_shape(M, K, N) || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32 ? bwd_any<float>(x, w, b, gamma, dy, dz, vecs, col_part, M, K, N,
                               gelu, ln, eps, G, w_terms, s)
              : bwd_any<__nv_bfloat16>(x, w, b, gamma, dy, dz, vecs, col_part,
                                       M, K, N, gelu, ln, eps, G, w_terms, s);
}
