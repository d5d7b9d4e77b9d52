// K1: SwinV2 flat-layout cosine window attention, forward; K2, its v2
// backward (the training path's default), and K5, its v1 backward.
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
// them. Bound: 4*Bn*H*N^2*hd fp32 operations against the card's 67 TFLOP/s
// non-tensor fp32 rate, ahead of the Bn*H*N^2 exponentials against the
// special-function units (16 per SM per clock, 132 SMs at 1.98 GHz: 4.2e12
// per second) and of the bytes (qkv, bias and out, once each). This first
// version is written to be right and simple; it keeps the products off the
// tensor cores and re-reads q/k/v per tile from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TQ = 64;            // query rows per block
constexpr int TK = 64;            // key rows per tile
constexpr int SUB = 4;            // threads per query row
constexpr int THREADS = TQ * SUB;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ int region(int idx, int ws, int shift, bool last_i,
                                      bool last_j) {
  const int r = idx / ws, c = idx % ws;
  return 3 * (last_i && r >= ws - shift) + (last_j && c >= ws - shift);
}

template <typename T, int HD>
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
  for (int d = 0; d < HD; ++d) q[d] *= qr;

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
      vs[r][d] = j < N ? to_f(p[2 * C]) : 0.f;
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
      for (int d = 0; d < HD; ++d) ks[tid][d] *= kr;
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
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += e * vs[jj][d];
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
            int H, int ws, int shift, int nWh, int nWw, cudaStream_t stream) {
  const dim3 grid((N + TQ - 1) / TQ, H, Bn);
  flat_fwd<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(scale), static_cast<const float*>(shiftm),
      static_cast<T*>(out), static_cast<float*>(rsum), N, C, ws, shift, nWh,
      nWw);
}

// ---------------------------------------------------------------- K2
//
// K2 replaces `pallas_window_attention_flat_bwd2` (body `_flat_bwd2_body`,
// mvuld_tpu/ops/window_attention.py), the v2 backward: it reads the
// forward's output o and row sums r and never replays the forward.
// Per window b and head h, with q^ = q*qn, k^ = k*kn:
//
//   p  = exp(q^.k^ * scale + bias + mask - m + log r)    (softmax probs)
//   t  = rowsum(g * o);  dp = g.v^T;  ds = p * (dp - t)
//   dq^ = scale * ds.k^;   dk^ = scale * ds^T.q^;   dv = p^T.g
//   dq = (dq^ - q^ (q^.dq^)) * qn, dk likewise      (rsqrt-norm backward)
//   dbias[h] = sum over windows of ds;  dscale[h] = sum (q^.dq^) / scale
//
// Design. dq sums over keys, dk and dv over queries, dbias over windows, so
// three kernels own one reduction each and none needs atomics:
//   bwd_dq    block (query tile, head, window): loops over key tiles;
//   bwd_dkv   block (key tile, head, window): loops over query tiles;
//   bwd_dbias block (key tile, query tile, head): loops over all windows,
//             summing its ds tile in registers in window order, so dbias
//             is deterministic and no per-window partial (256 x 4 x 784^2
//             fp32 = 2.5 GB at stage 1) is ever written. Its first block of
//             each head also sums bwd_dq's per-block dscale partials.
// Each recomputes the 64 x 64 (p, ds) tile it needs with register
// micro-tiles (4 x 4 per thread, interleaved rows/cols to keep shared
// memory conflict-free); bwd_dq and bwd_dkv stage ds (and p) in shared
// memory for the second product. Products are fp32 FMAs as in K1 (the
// Pallas default keeps mxu_bf16 off). Bound: about 10*Bn*H*N^2*hd fp32
// operations (s, dp, dq^, dk^, dv) at 67 TFLOP/s; this design spends
// about 18 (s and dp are recomputed by each of the three kernels) and is
// written to be right first.

constexpr int BT = 64;    // rows per query or key tile
constexpr int LD = 33;    // padded row of a [BT][32] fp32 tile
constexpr int LDS = 65;   // padded row of a [BT][BT] fp32 tile

struct Geo {
  int N, C, ws, shift, nWh, nWw, H;
};

// Query-side tile of window b, head h, rows i0..i0+63 (zero past N):
// Qs = q^ (normalised), Gs = g, qn, lr = log r - m and tt, the row term
// that ds subtracts from dp. K2 takes tt = rowsum(g*o) from the forward's
// output o; K5 passes tsum (t' = r * sum dp*e from `bwd_rowstats`) and no
// o. Without rsum (K5's first pass) lr = -m, so p_ds_tile's p is e itself,
// and without o or tsum tt = 0, so its ds is e*dp.
template <typename T>
__device__ void stage_query(const T* qkv, const T* o, const T* g,
                            const float* rsum, const float* tsum, float mh,
                            const Geo& G, int b, int h, int i0, float* Qs,
                            float* Gs, float* lr, float* tt, float* qn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t C3 = 3 * (size_t)G.C;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int i = i0 + r;
    float q = 0.f, gv = 0.f, ov = 0.f;
    if (i < G.N) {
      const size_t row = (size_t)b * G.N + i;
      q = to_f(qkv[row * C3 + h * 32 + lane]);
      gv = to_f(g[row * G.C + h * 32 + lane]);
      if (o != nullptr) ov = to_f(o[row * G.C + h * 32 + lane]);
    }
    const float n = rsqrtf(warp_sum(q * q) + 1e-12f);
    const float go = warp_sum(gv * ov);
    Qs[r * LD + lane] = q * n;
    Gs[r * LD + lane] = gv;
    if (lane == 0) {
      const size_t stat = ((size_t)b * G.H + h) * G.N + i;
      qn[r] = n;
      tt[r] = (tsum != nullptr && i < G.N) ? tsum[stat] : go;
      lr[r] = (rsum != nullptr && i < G.N) ? logf(rsum[stat]) - mh : -mh;
    }
  }
}

// Key-side tile: Ks = k^ (normalised), Vs = v, kn (zero past N).
template <typename T>
__device__ void stage_key(const T* qkv, const Geo& G, int b, int h, int j0,
                          float* Ks, float* Vs, float* kn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t C3 = 3 * (size_t)G.C;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int j = j0 + r;
    float k = 0.f, v = 0.f;
    if (j < G.N) {
      const T* p = qkv + ((size_t)b * G.N + j) * C3 + h * 32 + lane;
      k = to_f(p[G.C]);
      v = to_f(p[2 * G.C]);
    }
    const float n = rsqrtf(warp_sum(k * k) + 1e-12f);
    Ks[r * LD + lane] = k * n;
    Vs[r * LD + lane] = v;
    if (kn != nullptr && lane == 0) kn[r] = n;
  }
}

// This thread's 4 x 4 micro-tile of p and ds: rows ty + 16a of the query
// tile i0, columns tx + 16c of the key tile j0. Zero outside N x N.
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* Gs, const float* Ks, const float* Vs,
    const float* lr, const float* tt, const float* bias, float sc,
    const Geo& G, int b, int h, int i0, int j0, float p[4][4],
    float ds[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < 32; ++d) {
    float qa[4], ga[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = Qs[(ty + 16 * a) * LD + d];
      ga[a] = Gs[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = Ks[(tx + 16 * c) * LD + d];
      vc[c] = Vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] += qa[a] * kc[c];
        dp[a][c] += ga[a] * vc[c];
      }
  }
  bool last_i = false, last_j = false;
  if (G.shift > 0) {
    const int wid = b % (G.nWh * G.nWw);
    last_i = wid / G.nWw == G.nWh - 1;
    last_j = wid % G.nWw == G.nWw - 1;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      float pv = 0.f;
      if (i < G.N && j < G.N) {
        float x = s[a][c] * sc + bias[((size_t)h * G.N + i) * G.N + j] + lr[r];
        if (G.shift > 0 && region(i, G.ws, G.shift, last_i, last_j) !=
                               region(j, G.ws, G.shift, last_i, last_j))
          x += -100.f;
        pv = expf(x);
      }
      p[a][c] = pv;
      ds[a][c] = pv * (dp[a][c] - tt[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_dq(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shiftm,
    const T* __restrict__ o, const float* __restrict__ rsum,
    const float* __restrict__ tsum, const T* __restrict__ g,
    T* __restrict__ dqkv, float* __restrict__ dscale_part, Geo G) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* DS = Vs + BT * LD;        // [BT][LDS]
  float* lr = DS + BT * LDS;
  float* tt = lr + BT;
  float* qn = tt + BT;
  float* red = qn + BT;            // [THREADS / 32]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, i0 = qt * BT;
  const float sc = scale[h];
  stage_query(qkv, o, g, rsum, tsum, shiftm[h], G, b, h, i0, Qs, Gs, lr, tt,
              qn);

  float acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = 0.f;
  for (int j0 = 0; j0 < G.N; j0 += BT) {
    __syncthreads();   // staging done / previous tile consumed
    stage_key(qkv, G, b, h, j0, Ks, Vs, nullptr);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile(Qs, Gs, Ks, Vs, lr, tt, bias, sc, G, b, h, i0, j0, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) DS[(ty + 16 * a) * LDS + tx + 16 * c] = ds[a][c];
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      const float k0 = Ks[j * LD + tx], k1 = Ks[j * LD + tx + 16];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float dsv = DS[(ty + 16 * a) * LDS + j];
        acc[a][0] += dsv * k0;
        acc[a][1] += dsv * k1;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {     // dq^ into Ks (free now)
    Ks[(ty + 16 * a) * LD + tx] = acc[a][0] * sc;
    Ks[(ty + 16 * a) * LD + tx + 16] = acc[a][1] * sc;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  float part = 0.f;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int i = i0 + r;
    const float qh = Qs[r * LD + lane], dqh = Ks[r * LD + lane];
    const float rowq = warp_sum(qh * dqh);
    if (i < G.N) {
      const size_t row = (size_t)b * G.N + i;
      store(dqkv + row * 3 * G.C + h * 32 + lane, (dqh - qh * rowq) * qn[r]);
      part += rowq;
    }
  }
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) tot += red[w];
    dscale_part[((size_t)b * G.H + h) * gridDim.x + qt] = tot / sc;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_dkv(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shiftm,
    const T* __restrict__ o, const float* __restrict__ rsum,
    const float* __restrict__ tsum, const T* __restrict__ g,
    T* __restrict__ dqkv, Geo G) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* P = Vs + BT * LD;          // [BT][LDS]
  float* DS = P + BT * LDS;         // [BT][LDS]
  float* lr = DS + BT * LDS;
  float* tt = lr + BT;
  float* qn = tt + BT;
  float* kn = qn + BT;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, j0 = kt * BT;
  const float sc = scale[h], mh = shiftm[h];
  stage_key(qkv, G, b, h, j0, Ks, Vs, kn);

  float dv[4][2], dk[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) dv[a][0] = dv[a][1] = dk[a][0] = dk[a][1] = 0.f;
  for (int i0 = 0; i0 < G.N; i0 += BT) {
    __syncthreads();
    stage_query(qkv, o, g, rsum, tsum, mh, G, b, h, i0, Qs, Gs, lr, tt, qn);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile(Qs, Gs, Ks, Vs, lr, tt, bias, sc, G, b, h, i0, j0, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        P[(ty + 16 * a) * LDS + tx + 16 * c] = p[a][c];
        DS[(ty + 16 * a) * LDS + tx + 16 * c] = ds[a][c];
      }
    __syncthreads();
    // this thread: key rows ty + 16a, dims tx and tx + 16
    for (int i = 0; i < BT; ++i) {
      const float g0 = Gs[i * LD + tx], g1 = Gs[i * LD + tx + 16];
      const float q0 = Qs[i * LD + tx], q1 = Qs[i * LD + tx + 16];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pv = P[i * LDS + ty + 16 * a];
        const float dsv = DS[i * LDS + ty + 16 * a];
        dv[a][0] += pv * g0;
        dv[a][1] += pv * g1;
        dk[a][0] += dsv * q0;
        dk[a][1] += dsv * q1;
      }
    }
  }
  __syncthreads();
  const size_t C3 = 3 * (size_t)G.C;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, j = j0 + r;
    P[r * LD + tx] = dk[a][0] * sc;       // dk^ into P (free now)
    P[r * LD + tx + 16] = dk[a][1] * sc;
    if (j < G.N) {
      T* dvp = dqkv + ((size_t)b * G.N + j) * C3 + 2 * G.C + h * 32;
      store(dvp + tx, dv[a][0]);
      store(dvp + tx + 16, dv[a][1]);
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int j = j0 + r;
    const float kh = Ks[r * LD + lane], dkh = P[r * LD + lane];
    const float rowk = warp_sum(kh * dkh);
    if (j < G.N)
      store(dqkv + ((size_t)b * G.N + j) * C3 + G.C + h * 32 + lane,
            (dkh - kh * rowk) * kn[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_dbias(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shiftm,
    const T* __restrict__ o, const float* __restrict__ rsum,
    const float* __restrict__ tsum, const T* __restrict__ g,
    float* __restrict__ dbias,
    const float* __restrict__ dscale_part, float* __restrict__ dscale,
    int Bn, int nqt, Geo G) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* lr = Vs + BT * LD;
  float* tt = lr + BT;
  float* qn = tt + BT;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int j0 = blockIdx.x * BT, i0 = blockIdx.y * BT, h = blockIdx.z;
  const float sc = scale[h], mh = shiftm[h];
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int b = 0; b < Bn; ++b) {
    __syncthreads();
    stage_query(qkv, o, g, rsum, tsum, mh, G, b, h, i0, Qs, Gs, lr, tt, qn);
    stage_key(qkv, G, b, h, j0, Ks, Vs, nullptr);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile(Qs, Gs, Ks, Vs, lr, tt, bias, sc, G, b, h, i0, j0, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] += ds[a][c];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < G.N && j < G.N) dbias[((size_t)h * G.N + i) * G.N + j] = acc[a][c];
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    float tot = 0.f;   // bwd_dq's partials of this head, in a fixed order
    for (int b = 0; b < Bn; ++b)
      for (int q = 0; q < nqt; ++q)
        tot += dscale_part[((size_t)b * G.H + h) * nqt + q];
    dscale[h] = tot;
  }
}

// ---------------------------------------------------------------- K5
//
// K5 replaces `pallas_window_attention_flat_bwd` (body
// `_flat_bwd_kernel_factory`, mvuld_tpu/ops/window_attention.py), the v1
// backward: it keeps only (qkv, bias, scale) from the forward and rebuilds
// the softmax statistics itself. Per window, head and query row, over all
// N keys:
//
//   e = exp(s - m);  r = 1 / max(sum e, 1e-30);  t = sum dp*e;  t' = r*t
//   ds = e * (r * (dp - r*t)) = p * (dp - t')     with p = e*r
//
// and the rest is K2's (dq^, dk^, dv = p^T g, dbias, dscale). The Pallas
// kernel forms ds as e*(r*(dp - r*t)) and never r^2*t: the clamped r can
// reach 1e30 and r^2 overflows fp32. Here r*t is formed once per row
// (bounded: |r*t| <= max|dp|) and p = exp(s - m + log r), so no product
// of r with r or with an unbounded term is ever taken.
//
// Design. `bwd_rowstats` is the extra pass: block (query tile, head,
// window), looping over the key tiles with p_ds_tile at lr = -m and tt = 0
// (so its p is e and its ds is e*dp), summing both per row in registers
// and across the 16 threads of a row with shuffles, in key order. It
// writes r and t' ([Bn, H, N] fp32 each), which the three K2 kernels then
// read in place of the forward's row sums and rowsum(g*o). The pass
// recomputes s and dp for the whole row once more: about 4 of K2's 18
// FMA-flops per N^2*hd, so K5 costs about 1.2x K2. Its t comes from fp32
// e*dp, not from the bf16 output o that K2 reads.

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_rowstats(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shiftm,
    const T* __restrict__ g, float* __restrict__ rsum,
    float* __restrict__ tsum, Geo G) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* lr = Vs + BT * LD;
  float* tt = lr + BT;
  float* qn = tt + BT;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.y, b = blockIdx.z, i0 = blockIdx.x * BT;
  const float sc = scale[h];
  stage_query<T>(qkv, nullptr, g, nullptr, nullptr, shiftm[h], G, b, h, i0,
                 Qs, Gs, lr, tt, qn);
  float se[4] = {0.f, 0.f, 0.f, 0.f}, st[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < G.N; j0 += BT) {
    __syncthreads();
    stage_key(qkv, G, b, h, j0, Ks, Vs, nullptr);
    __syncthreads();
    float e[4][4], edp[4][4];
    p_ds_tile(Qs, Gs, Ks, Vs, lr, tt, bias, sc, G, b, h, i0, j0, e, edp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float ue = 0.f, ut = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ue += e[a][c];
        ut += edp[a][c];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {   // the 16 threads of a row
        ue += __shfl_xor_sync(0xffffffffu, ue, off);
        ut += __shfl_xor_sync(0xffffffffu, ut, off);
      }
      se[a] += ue;
      st[a] += ut;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i < G.N) {
        const size_t stat = ((size_t)b * G.H + h) * G.N + i;
        const float r = 1.f / fmaxf(se[a], 1e-30f);
        rsum[stat] = r;
        tsum[stat] = r * st[a];
      }
    }
  }
}

constexpr size_t TILE_F = (size_t)BT * LD;
constexpr size_t SQ_F = (size_t)BT * LDS;
constexpr size_t SMEM_DQ = (4 * TILE_F + SQ_F + 3 * BT + THREADS / 32) * 4;
constexpr size_t SMEM_DKV = (4 * TILE_F + 2 * SQ_F + 4 * BT) * 4;
constexpr size_t SMEM_DB = (4 * TILE_F + 3 * BT) * 4;   // also bwd_rowstats

// K2 (o and rsum from the forward, tsum null) or, after bwd_rowstats, K5
// (o null, rsum and tsum from the row pass).
template <typename T>
int launch_bwd(const void* qkv, const void* bias, const void* scale,
               const void* shiftm, const void* o, const void* rsum,
               const void* tsum, const void* g, void* dqkv, void* dbias,
               void* dscale, void* dscale_part, int Bn, const Geo& G,
               cudaStream_t stream) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_dq<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(SMEM_DQ))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dkv<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(SMEM_DKV))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dbias<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(SMEM_DB))) != cudaSuccess)
    return static_cast<int>(err);
  const int nt = (G.N + BT - 1) / BT;
  const T* q = static_cast<const T*>(qkv);
  const float* bi = static_cast<const float*>(bias);
  const float* sc = static_cast<const float*>(scale);
  const float* mh = static_cast<const float*>(shiftm);
  const T* ov = static_cast<const T*>(o);
  const float* r = static_cast<const float*>(rsum);
  const float* t = static_cast<const float*>(tsum);
  const T* gv = static_cast<const T*>(g);
  float* part = static_cast<float*>(dscale_part);
  bwd_dq<T><<<dim3(nt, G.H, Bn), THREADS, SMEM_DQ, stream>>>(
      q, bi, sc, mh, ov, r, t, gv, static_cast<T*>(dqkv), part, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dkv<T><<<dim3(nt, G.H, Bn), THREADS, SMEM_DKV, stream>>>(
      q, bi, sc, mh, ov, r, t, gv, static_cast<T*>(dqkv), G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dbias<T><<<dim3(nt, nt, G.H), THREADS, SMEM_DB, stream>>>(
      q, bi, sc, mh, ov, r, t, gv, static_cast<float*>(dbias), part,
      static_cast<float*>(dscale), Bn, nt, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_v1(const void* qkv, const void* bias, const void* scale,
                  const void* shiftm, const void* g, void* dqkv, void* dbias,
                  void* dscale, void* dscale_part, void* rsum, void* tsum,
                  int Bn, const Geo& G, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rowstats<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_DB));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (G.N + BT - 1) / BT;
  bwd_rowstats<T><<<dim3(nt, G.H, Bn), THREADS, SMEM_DB, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(scale), static_cast<const float*>(shiftm),
      static_cast<const T*>(g), static_cast<float*>(rsum),
      static_cast<float*>(tsum), G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return launch_bwd<T>(qkv, bias, scale, shiftm, nullptr, rsum, tsum, g, dqkv,
                       dbias, dscale, dscale_part, Bn, G, stream);
}

}  // namespace

extern "C" int window_attention_flat_fwd(const void* qkv, const void* bias,
                                         const void* scale, const void* shiftm,
                                         void* out, void* rsum, int is_bf16,
                                         int Bn, int N, int C, int H, int ws,
                                         int shift, int nWh, int nWw,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C / H != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    launch<__nv_bfloat16, 32>(qkv, bias, scale, shiftm, out, rsum, Bn, N, C,
                              H, ws, shift, nWh, nWw, s);
  else
    launch<float, 32>(qkv, bias, scale, shiftm, out, rsum, Bn, N, C, H, ws,
                      shift, nWh, nWw, s);
  return static_cast<int>(cudaGetLastError());
}

// K2. dscale_part is scratch of Bn * H * ceil(N / 64) floats.
extern "C" int window_attention_flat_bwd(
    const void* qkv, const void* bias, const void* scale, const void* shiftm,
    const void* o, const void* rsum, const void* g, void* dqkv, void* dbias,
    void* dscale, void* dscale_part, int is_bf16, int Bn, int N, int C, int H,
    int ws, int shift, int nWh, int nWw, void* stream) {
  if (C / H != 32 || C % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geo G{N, C, ws, shift, nWh, nWw, H};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(qkv, bias, scale, shiftm, o, rsum,
                                         nullptr, g, dqkv, dbias, dscale,
                                         dscale_part, Bn, G, s)
             : launch_bwd<float>(qkv, bias, scale, shiftm, o, rsum, nullptr,
                                 g, dqkv, dbias, dscale, dscale_part, Bn, G,
                                 s);
}

// K5. Scratch: dscale_part as K2's; rsum and tsum [Bn, H, N] fp32 each.
extern "C" int window_attention_flat_bwd_v1(
    const void* qkv, const void* bias, const void* scale, const void* shiftm,
    const void* g, void* dqkv, void* dbias, void* dscale, void* dscale_part,
    void* rsum, void* tsum, int is_bf16, int Bn, int N, int C, int H, int ws,
    int shift, int nWh, int nWw, void* stream) {
  if (C / H != 32 || C % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geo G{N, C, ws, shift, nWh, nWw, H};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_bwd_v1<__nv_bfloat16>(qkv, bias, scale, shiftm, g, dqkv,
                                            dbias, dscale, dscale_part, rsum,
                                            tsum, Bn, G, s)
             : launch_bwd_v1<float>(qkv, bias, scale, shiftm, g, dqkv, dbias,
                                    dscale, dscale_part, rsum, tsum, Bn, G, s);
}
