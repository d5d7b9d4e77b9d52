// K1: SwinV2 flat-layout cosine window attention, forward. Its backward
// kernels, K2 (v2, the training path's default) and K5 (v1), run on the
// tensor-core passes of window_attention.cu.
//
// Replaces the Pallas TPU kernel `pallas_window_attention_flat`
// (mvuld_tpu/ops/window_attention.py, body `_flat_fwd_kernel_factory`).
// Same function, same layout: qkv [Bn, N, 3C] (batch-major windows), bias
// [H, N, N] fp32, per-head scale [H] and fixed softmax shift m [H]
// (m_h = scale_h + max(bias[h]), computed by the wrapper), output [Bn, N, C]
// in qkv's type, and optionally the reciprocal softmax row sums
// r = 1/max(sum e, 1e-30) as fp32 [Bn, H, N] (the backward's residual).
//
//   q^ = q * rsqrt(sum q^2 + 1e-12), k^ likewise (fp32)
//   s  = q^.k^ * scale_h + bias[h] + mask(window id, i, j)   (mask 0 / -100)
//   e  = exp(s - m_h);  out = (e . v) / max(sum e, 1e-30)
//
// Design. One block per (query tile of 64 rows, head, window); 256 threads,
// four per query row. The normalised q row lives in registers; the block
// loops over 64-row key tiles, staging normalised k, v and the bias tile in
// shared memory, with the ragged last tile (784 = 12*64 + 16) masked. The
// fixed shift m_h makes the key tiles' contributions to sum(e) and e.v
// plain sums, so no running-max rescale is needed and no N x N score block
// is ever held (one head's 784^2 fp32 scores would be 2.4 MB). The four
// threads of a row split the keys of a tile and combine with warp shuffles
// at the end. The shift mask is derived from the window id, as in the TPU
// kernel (`_window_region_mask`), so no [nW, N, N] mask is read.
//
// Products are fp32 FMAs, as the Pallas default (mxu_bf16=False) computes
// them; with `round_ops` (`mxu_bf16`) q^, k^, v and e are rounded to bf16
// before them, as the Pallas kernel rounds its MXU operands (the row sum
// stays the fp32 sum of e). Bound: 4*Bn*H*N^2*hd fp32 operations against
// the card's 67 TFLOP/s non-tensor fp32 rate, ahead of the Bn*H*N^2
// exponentials against the special-function units (16 per SM per clock, 132 SMs at 1.98 GHz: 4.2e12
// per second) and of the bytes (qkv, bias and out, once each). This first
// version is written to be right and simple; it keeps the products off the
// tensor cores and re-reads q/k/v per tile from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;            // query rows per block
constexpr int TK = 64;            // key rows per tile
constexpr int SUB = 4;            // threads per query row
constexpr int THREADS = TQ * SUB;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// x rounded to bf16 under ROUND (a template switch: the kernel without it
// is the one without rounding, instruction for instruction)
template <bool ROUND>
__device__ __forceinline__ float rnd(float x) {
  return ROUND ? __bfloat162float(__float2bfloat16(x)) : x;
}

__device__ __forceinline__ int region(int idx, int ws, int shift, bool last_i,
                                      bool last_j) {
  const int r = idx / ws, c = idx % ws;
  return 3 * (last_i && r >= ws - shift) + (last_j && c >= ws - shift);
}

template <typename T, int HD, bool ROUND>
__global__ void __launch_bounds__(THREADS) flat_fwd(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shiftm,
    T* __restrict__ out, float* __restrict__ rsum, int N, int C, int ws,
    int shift, int nWh, int nWw) {
  __shared__ float ks[TK][HD + 1];
  __shared__ float vs[TK][HD + 1];
  __shared__ float bs[TQ][TK + 1];

  const int tid = threadIdx.x;
  const int row = tid / SUB, sub = tid % SUB;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = q0 + row;
  const size_t C3 = 3 * (size_t)C;
  const T* base = qkv + (size_t)b * N * C3;

  // this thread's query row, normalised in fp32 (zero past N)
  float q[HD];
  float qq = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    q[d] = i < N ? to_f(base[(size_t)i * C3 + h * HD + d]) : 0.f;
    qq += q[d] * q[d];
  }
  const float qr = rsqrtf(qq + 1e-12f);
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = rnd<ROUND>(q[d] * qr);

  const float sc = scale[h], mh = shiftm[h];
  bool last_i = false, last_j = false;
  int reg_i = 0;
  if (shift > 0) {
    const int wid = b % (nWh * nWw);
    last_i = wid / nWw == nWh - 1;
    last_j = wid % nWw == nWw - 1;
    reg_i = region(i < N ? i : 0, ws, shift, last_i, last_j);
  }

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float lsum = 0.f;

  for (int k0 = 0; k0 < N; k0 += TK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < TK * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD, j = k0 + r;
      const T* p = base + (size_t)j * C3 + h * HD + d;
      ks[r][d] = j < N ? to_f(p[C]) : 0.f;
      vs[r][d] = j < N ? rnd<ROUND>(to_f(p[2 * C])) : 0.f;
    }
    for (int idx = tid; idx < TQ * TK; idx += THREADS) {
      const int r = idx / TK, c = idx % TK;
      const int ii = q0 + r, j = k0 + c;
      bs[r][c] = (ii < N && j < N) ? bias[((size_t)h * N + ii) * N + j] : 0.f;
    }
    __syncthreads();
    if (tid < TK) {  // normalise the key rows in place
      float kk = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) kk += ks[tid][d] * ks[tid][d];
      const float kr = rsqrtf(kk + 1e-12f);
#pragma unroll
      for (int d = 0; d < HD; ++d) ks[tid][d] = rnd<ROUND>(ks[tid][d] * kr);
    }
    __syncthreads();

    const int kn = min(TK, N - k0);
    for (int jj = sub; jj < kn; jj += SUB) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += q[d] * ks[jj][d];
      float s = dot * sc + bs[row][jj];
      if (shift > 0 && region(k0 + jj, ws, shift, last_i, last_j) != reg_i)
        s += -100.f;
      const float e = expf(s - mh);
      lsum += e;
      const float eo = rnd<ROUND>(e);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += eo * vs[jj][d];
    }
  }

  // combine the SUB threads of this row (adjacent lanes of one warp)
#pragma unroll
  for (int off = 1; off < SUB; off <<= 1) {
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
#pragma unroll
    for (int d = 0; d < HD; ++d)
      acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  if (i < N) {
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    if (rsum != nullptr && sub == 0)
      rsum[((size_t)b * gridDim.y + h) * N + i] = inv;
    T* o = out + ((size_t)b * N + i) * C + h * HD;
    constexpr int PER = HD / SUB;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d / PER == sub) store(o + d, acc[d] * inv);
  }
}

template <typename T, int HD>
void launch(const void* qkv, const void* bias, const void* scale,
            const void* shiftm, void* out, void* rsum, int Bn, int N, int C,
            int H, int ws, int shift, int nWh, int nWw, int round_ops,
            cudaStream_t stream) {
  const dim3 grid((N + TQ - 1) / TQ, H, Bn);
  const auto kernel = round_ops ? flat_fwd<T, HD, true> : flat_fwd<T, HD, false>;
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(scale), static_cast<const float*>(shiftm),
      static_cast<T*>(out), static_cast<float*>(rsum), N, C, ws, shift, nWh,
      nWw);
}

}  // namespace

extern "C" int window_attention_flat_fwd(const void* qkv, const void* bias,
                                         const void* scale, const void* shiftm,
                                         void* out, void* rsum, int is_bf16,
                                         int Bn, int N, int C, int H, int ws,
                                         int shift, int nWh, int nWw,
                                         int round_ops, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C / H != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    launch<__nv_bfloat16, 32>(qkv, bias, scale, shiftm, out, rsum, Bn, N, C,
                              H, ws, shift, nWh, nWw, round_ops, s);
  else
    launch<float, 32>(qkv, bias, scale, shiftm, out, rsum, Bn, N, C, H, ws,
                      shift, nWh, nWw, round_ops, s);
  return static_cast<int>(cudaGetLastError());
}
