// K8/K8b: SwinV2 cosine window attention in the head layout, forward and
// backward; K7/K7b: the same attention read straight from the feature map.
//
// They replace the Pallas TPU kernels `pallas_window_attention` (K8),
// `pallas_window_attention_bwd` (K8b), `pallas_window_attention_map` (K7)
// and `pallas_window_attention_map_bwd` (K7b) of
// mvuld_tpu/ops/window_attention.py. Per window b and head h:
//
//   q^ = q * rsqrt(sum q^2 + 1e-12), k^ likewise (fp32)
//   s  = q^.k^ * scale_h + bias[h] + mask          (s_cos = q^.k^)
//   p  = softmax(s) over the keys, exact (row max subtracted)
//   out = p . v
//   dv = p^T.g;  dp = g.v^T;  ds = p * (dp - rowsum(dp * p))
//   dq^ = scale * ds.k^;  dk^ = scale * ds^T.q^
//   dq = (dq^ - q^ (q^.dq^)) * qn, dk likewise     (rsqrt-norm backward)
//   dbias[h] = sum over windows of ds;  dscale[h] = sum of ds * s_cos
//
// One set of kernels serves both layouts: a layout descriptor (`Lay`) turns
// (window, head, token) into an address, so the head layout reads q, k, v
// [Bn, H, N, hd] and the map layout reads the window's tokens in place from
// qkv [B, Hp, Wp, 3, H, hd] and writes [B, Hp, Wp, H, hd] (dqkv in qkv's
// layout). The mask is either an operand [nW, N, N], read at b % nW (K8), or
// synthesised from the window's grid coordinates (K7: tokens of a window in
// the last window row / column of the rolled map attend only within their
// shift region, -100 otherwise), or absent.
//
// Exact softmax. With an arbitrary mask operand no fixed shift bounds the
// logits, so the row maximum is found first. The forward's block (query
// tile of 64 rows, head, window) walks the 64-row key tiles twice: the
// first walk keeps a running (max, sum of exp) per row with a rescale when
// the maximum grows, the second forms p = exp(s - max) / sum, stages the
// 64 x 64 tile of p in shared memory and adds p.v. p is formed whole before
// the second product because the bf16 variants round p itself (K8 rounds p
// to v's type, `mxu_bf16` rounds every product operand), and a rounded
// unnormalised e would not be that number. The backward's first kernel
// (`bwd_rowstats`) is the same walk with dp beside s: per row it writes
// lr = -(max + log sum) and t = sum(dp * p); the three kernels after it form
// p = exp(s + lr), ds = p * (dp - t) for their tile, each owning one
// reduction (dq over keys, dk/dv over queries, dbias and dscale over every
// window in a fixed order), so no sum needs an atomic. dscale is the direct
// sum of ds * s_cos, per (key tile, query tile, head) block and then over
// the blocks of a head in a fixed order.
//
// Products are fp32 FMAs on 4 x 4 register micro-tiles; with `round_ops`
// (`mxu_bf16`) q^, k^, v, g, p and ds are rounded to bf16 where they are
// staged and the sums stay fp32, which is what the TPU kernel's bf16 MXU
// operands compute. Head dim 32 (SwinV2's). Written to be right and simple:
// about 6*N^2*hd FMA-flops per window and head forward (s twice) against the
// bound's 4, and about 22 backward (s and dp by each of four kernels)
// against 10.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BT = 64;    // rows per query or key tile
constexpr int LD = 33;    // padded row of a [BT][32] fp32 tile
constexpr int LDS = 65;   // padded row of a [BT][BT] fp32 tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float rnd(float x, int on) {
  return on ? __bfloat162float(__float2bfloat16(x)) : x;
}

// Where token i of window b, head h starts (in elements). Head layout:
// b*win + h*head + i*tok. Map layout: window b = (image, window row, window
// column), token i = (row, column) within it, on a [*, Hp, Wp] map of
// `tok` elements per position.
struct Lay {
  int map, ws, nWw, nW, Hp, Wp;
  long long tok, head, win;
};

__device__ __forceinline__ size_t at(const Lay& L, int b, int h, int i) {
  if (!L.map) return (size_t)b * L.win + (size_t)h * L.head + (size_t)i * L.tok;
  const int img = b / L.nW, wid = b % L.nW;
  const size_t row = ((size_t)img * L.Hp + (wid / L.nWw) * L.ws + i / L.ws) * L.Wp +
                     (wid % L.nWw) * L.ws + i % L.ws;
  return row * L.tok + (size_t)h * L.head;
}

struct Geo {
  int N, H, ws, shift, nWh, nWw;  // shift > 0: the mask is synthesised
  int nWmask;                     // windows of the mask operand, if any
  int round_ops, round_p;
  Lay in, out;                    // q, k, v, dq, dk, dv; out and g
};

__device__ __forceinline__ int region(int idx, int ws, int shift, bool last_i,
                                      bool last_j) {
  const int r = idx / ws, c = idx % ws;
  return 3 * (last_i && r >= ws - shift) + (last_j && c >= ws - shift);
}

// The mask of one window: an operand slice, the shift regions, or nothing.
struct WinMask {
  const float* op;
  bool synth, last_i, last_j;
};

__device__ __forceinline__ WinMask win_mask(const Geo& G, const float* mask, int b) {
  WinMask W{nullptr, false, false, false};
  if (mask != nullptr) {
    W.op = mask + (size_t)(b % G.nWmask) * G.N * G.N;
  } else if (G.shift > 0) {
    const int wid = b % (G.nWh * G.nWw);
    W.synth = true;
    W.last_i = wid / G.nWw == G.nWh - 1;
    W.last_j = wid % G.nWw == G.nWw - 1;
  }
  return W;
}

// s = s_cos * scale + bias + mask at (i, j), both inside N
__device__ __forceinline__ float logit(const Geo& G, const WinMask& W,
                                       const float* bias, float sc, int h, int i,
                                       int j, float s_cos) {
  float x = s_cos * sc + bias[((size_t)h * G.N + i) * G.N + j];
  if (W.op != nullptr) x += W.op[(size_t)i * G.N + j];
  if (W.synth && region(i, G.ws, G.shift, W.last_i, W.last_j) !=
                     region(j, G.ws, G.shift, W.last_i, W.last_j))
    x += -100.f;
  return x;
}

// Query-side tile of window b, head h, rows i0..i0+63 (zero past N): Qs = q^
// (rounded under round_ops), qn, and where given Gs = g and the row
// statistics lr, tt.
template <typename T, typename TO>
__device__ void stage_query(const T* q, const TO* g, const float* lr_g,
                            const float* tt_g, const Geo& G, int b, int h,
                            int i0, float* Qs, float* Gs, float* lr, float* tt,
                            float* qn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int i = i0 + r;
    float qv = 0.f, gv = 0.f;
    if (i < G.N) {
      qv = to_f(q[at(G.in, b, h, i) + lane]);
      if (g != nullptr) gv = to_f(g[at(G.out, b, h, i) + lane]);
    }
    const float n = rsqrtf(warp_sum(qv * qv) + 1e-12f);
    Qs[r * LD + lane] = rnd(qv * n, G.round_ops);
    if (Gs != nullptr) Gs[r * LD + lane] = rnd(gv, G.round_ops);
    if (lane == 0) {
      const size_t stat = ((size_t)b * G.H + h) * G.N + i;
      qn[r] = n;
      if (lr != nullptr) lr[r] = (lr_g != nullptr && i < G.N) ? lr_g[stat] : 0.f;
      if (tt != nullptr) tt[r] = (tt_g != nullptr && i < G.N) ? tt_g[stat] : 0.f;
    }
  }
}

// Key-side tile: Ks = k^, Vs = v (rounded under round_ops), kn; zero past N.
template <typename T>
__device__ void stage_key(const T* k, const T* v, const Geo& G, int b, int h,
                          int j0, float* Ks, float* Vs, float* kn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int j = j0 + r;
    float kv = 0.f, vv = 0.f;
    if (j < G.N) {
      const size_t a = at(G.in, b, h, j) + lane;
      kv = to_f(k[a]);
      if (Vs != nullptr) vv = to_f(v[a]);
    }
    const float n = rsqrtf(warp_sum(kv * kv) + 1e-12f);
    Ks[r * LD + lane] = rnd(kv * n, G.round_ops);
    if (Vs != nullptr) Vs[r * LD + lane] = rnd(vv, G.round_ops);
    if (kn != nullptr && lane == 0) kn[r] = n;
  }
}

// This thread's 4 x 4 micro-tile of s_cos = q^.k^ and, with DP, dp = g.v:
// rows ty + 16a of the query tile, columns tx + 16c of the key tile.
template <bool DP>
__device__ __forceinline__ void dots(const float* Qs, const float* Gs,
                                     const float* Ks, const float* Vs,
                                     float s[4][4], float dp[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
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
      if (DP) ga[a] = Gs[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = Ks[(tx + 16 * c) * LD + d];
      if (DP) vc[c] = Vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] += qa[a] * kc[c];
        if (DP) dp[a][c] += ga[a] * vc[c];
      }
  }
}

// The micro-tile's logits: x = s_cos*scale + bias + mask inside N x N; a key
// past N gives -inf (it takes no part in the softmax), a query row past N a
// finite 0 (its results are never stored).
__device__ __forceinline__ void logits(const Geo& G, const WinMask& W,
                                       const float* bias, float sc, int h,
                                       int i0, int j0, const float s[4][4],
                                       float x[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      x[a][c] = j >= G.N ? -CUDART_INF_F
                         : (i >= G.N ? 0.f : logit(G, W, bias, sc, h, i, j, s[a][c]));
    }
  }
}

// One key tile's step of the running row statistics: the 16 threads of a
// row (adjacent lanes) agree on the tile's maximum, rescale what they hold
// and add the tile's exp sums (and, with dp, the sums of exp * dp).
template <bool DP>
__device__ __forceinline__ void online_step(const float x[4][4],
                                            const float dp[4][4], float m[4],
                                            float l[4], float st[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float tmax = fmaxf(fmaxf(x[a][0], x[a][1]), fmaxf(x[a][2], x[a][3]));
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float mn = fmaxf(m[a], tmax);
    float ue = 0.f, ut = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float e = expf(x[a][c] - mn);
      ue += e;
      if (DP) ut += e * dp[a][c];
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      ue += __shfl_xor_sync(0xffffffffu, ue, off);
      if (DP) ut += __shfl_xor_sync(0xffffffffu, ut, off);
    }
    const float cf = expf(m[a] - mn);   // 0 on the first tile (m = -inf)
    l[a] = l[a] * cf + ue;
    if (DP) st[a] = st[a] * cf + ut;
    m[a] = mn;
  }
}

// ---------------------------------------------------------------- forward

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS) attn_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ mask, TO* __restrict__ out, Geo G) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* P = Vs + BT * LD;          // [BT][LDS]
  float* qn = P + BT * LDS;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.y, b = blockIdx.z, i0 = blockIdx.x * BT;
  const float sc = scale[h];
  const WinMask W = win_mask(G, mask, b);
  stage_query<T, TO>(q, nullptr, nullptr, nullptr, G, b, h, i0, Qs, nullptr,
                     nullptr, nullptr, qn);

  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -CUDART_INF_F;
    l[a] = 0.f;
  }
  for (int j0 = 0; j0 < G.N; j0 += BT) {      // first walk: max and sum
    __syncthreads();
    stage_key<T>(k, v, G, b, h, j0, Ks, nullptr, nullptr);
    __syncthreads();
    float s[4][4], x[4][4];
    dots<false>(Qs, nullptr, Ks, nullptr, s, x);   // no dp: x is scratch
    logits(G, W, bias, sc, h, i0, j0, s, x);
    online_step<false>(x, x, m, l, l);             // no dp sums either
  }

  float acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = 0.f;
  for (int j0 = 0; j0 < G.N; j0 += BT) {      // second walk: p and p.v
    __syncthreads();
    stage_key<T>(k, v, G, b, h, j0, Ks, Vs, nullptr);
    __syncthreads();
    float s[4][4], x[4][4];
    dots<false>(Qs, nullptr, Ks, nullptr, s, x);
    logits(G, W, bias, sc, h, i0, j0, s, x);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        P[(ty + 16 * a) * LDS + tx + 16 * c] =
            rnd(expf(x[a][c] - m[a]) / l[a], G.round_p);
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      const float v0 = Vs[j * LD + tx], v1 = Vs[j * LD + tx + 16];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pv = P[(ty + 16 * a) * LDS + j];
        acc[a][0] += pv * v0;
        acc[a][1] += pv * v1;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i < G.N) {
      TO* o = out + at(G.out, b, h, i);
      store(o + tx, acc[a][0]);
      store(o + tx + 16, acc[a][1]);
    }
  }
}

// --------------------------------------------------------------- backward

// Row statistics of the recomputed softmax: lr = -(max + log sum exp), so
// that p = exp(s + lr), and t = sum(dp * p). [Bn, H, N] fp32 each.
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS) bwd_rowstats(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ mask, const TO* __restrict__ g,
    float* __restrict__ lr_g, float* __restrict__ tt_g, Geo G) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* qn = Vs + BT * LD;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.y, b = blockIdx.z, i0 = blockIdx.x * BT;
  const float sc = scale[h];
  const WinMask W = win_mask(G, mask, b);
  stage_query<T, TO>(q, g, nullptr, nullptr, G, b, h, i0, Qs, Gs, nullptr,
                     nullptr, qn);
  float m[4], l[4], st[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -CUDART_INF_F;
    l[a] = st[a] = 0.f;
  }
  for (int j0 = 0; j0 < G.N; j0 += BT) {
    __syncthreads();
    stage_key<T>(k, v, G, b, h, j0, Ks, Vs, nullptr);
    __syncthreads();
    float s[4][4], dp[4][4], x[4][4];
    dots<true>(Qs, Gs, Ks, Vs, s, dp);
    logits(G, W, bias, sc, h, i0, j0, s, x);
    online_step<true>(x, dp, m, l, st);
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i < G.N) {
        const size_t stat = ((size_t)b * G.H + h) * G.N + i;
        lr_g[stat] = -(m[a] + logf(l[a]));
        tt_g[stat] = st[a] / l[a];
      }
    }
  }
}

// The micro-tile's p, ds and s_cos from the staged tiles and row statistics
// (zero outside N x N).
__device__ __forceinline__ void p_ds_tile(
    const float* Qs, const float* Gs, const float* Ks, const float* Vs,
    const float* lr, const float* tt, const float* bias, float sc,
    const Geo& G, const WinMask& W, int h, int i0, int j0, float p[4][4],
    float ds[4][4], float s[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float dp[4][4];
  dots<true>(Qs, Gs, Ks, Vs, s, dp);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      float pv = 0.f;
      if (i < G.N && j < G.N)
        pv = expf(logit(G, W, bias, sc, h, i, j, s[a][c]) + lr[r]);
      p[a][c] = pv;
      ds[a][c] = pv * (dp[a][c] - tt[r]);
    }
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS) bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ mask, const TO* __restrict__ g,
    const float* __restrict__ lr_g, const float* __restrict__ tt_g,
    TO* __restrict__ dq, Geo G) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* DS = Vs + BT * LD;        // [BT][LDS]
  float* lr = DS + BT * LDS;
  float* tt = lr + BT;
  float* qn = tt + BT;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.y, b = blockIdx.z, i0 = blockIdx.x * BT;
  const float sc = scale[h];
  const WinMask W = win_mask(G, mask, b);
  stage_query<T, TO>(q, g, lr_g, tt_g, G, b, h, i0, Qs, Gs, lr, tt, qn);

  float acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = 0.f;
  for (int j0 = 0; j0 < G.N; j0 += BT) {
    __syncthreads();   // staging done / previous tile consumed
    stage_key<T>(k, v, G, b, h, j0, Ks, Vs, nullptr);
    __syncthreads();
    float p[4][4], ds[4][4], s[4][4];
    p_ds_tile(Qs, Gs, Ks, Vs, lr, tt, bias, sc, G, W, h, i0, j0, p, ds, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        DS[(ty + 16 * a) * LDS + tx + 16 * c] = rnd(ds[a][c], G.round_ops);
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
  // through the normalisation, with the unrounded q^ re-read from q
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int i = i0 + r;
    if (i >= G.N) continue;         // whole warps leave together
    const size_t a = at(G.in, b, h, i) + lane;
    const float qh = to_f(q[a]) * qn[r], dqh = Ks[r * LD + lane];
    const float rowq = warp_sum(qh * dqh);
    store(dq + a, (dqh - qh * rowq) * qn[r]);
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS) bwd_dkv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ mask, const TO* __restrict__ g,
    const float* __restrict__ lr_g, const float* __restrict__ tt_g,
    TO* __restrict__ dk, TO* __restrict__ dv, Geo G) {
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
  const int h = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * BT;
  const float sc = scale[h];
  const WinMask W = win_mask(G, mask, b);
  stage_key<T>(k, v, G, b, h, j0, Ks, Vs, kn);

  float dva[4][2], dka[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) dva[a][0] = dva[a][1] = dka[a][0] = dka[a][1] = 0.f;
  for (int i0 = 0; i0 < G.N; i0 += BT) {
    __syncthreads();
    stage_query<T, TO>(q, g, lr_g, tt_g, G, b, h, i0, Qs, Gs, lr, tt, qn);
    __syncthreads();
    float p[4][4], ds[4][4], s[4][4];
    p_ds_tile(Qs, Gs, Ks, Vs, lr, tt, bias, sc, G, W, h, i0, j0, p, ds, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        P[(ty + 16 * a) * LDS + tx + 16 * c] = rnd(p[a][c], G.round_p);
        DS[(ty + 16 * a) * LDS + tx + 16 * c] = rnd(ds[a][c], G.round_ops);
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
        dva[a][0] += pv * g0;
        dva[a][1] += pv * g1;
        dka[a][0] += dsv * q0;
        dka[a][1] += dsv * q1;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, j = j0 + r;
    P[r * LD + tx] = dka[a][0] * sc;       // dk^ into P (free now)
    P[r * LD + tx + 16] = dka[a][1] * sc;
    if (j < G.N) {
      TO* dvp = dv + at(G.in, b, h, j);
      store(dvp + tx, dva[a][0]);
      store(dvp + tx + 16, dva[a][1]);
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int j = j0 + r;
    if (j >= G.N) continue;
    const size_t a = at(G.in, b, h, j) + lane;
    const float kh = to_f(k[a]) * kn[r], dkh = P[r * LD + lane];
    const float rowk = warp_sum(kh * dkh);
    store(dk + a, (dkh - kh * rowk) * kn[r]);
  }
}

// dbias[h] tile (i0, j0) summed over every window in window order, and this
// block's share of dscale[h] = sum ds * s_cos, written to
// part[(query tile * tiles + key tile) * H + h].
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS) bwd_dbias(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ mask, const TO* __restrict__ g,
    const float* __restrict__ lr_g, const float* __restrict__ tt_g,
    float* __restrict__ dbias, float* __restrict__ part, int Bn, Geo G) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Gs = Qs + BT * LD;
  float* Ks = Gs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* lr = Vs + BT * LD;
  float* tt = lr + BT;
  float* qn = tt + BT;
  float* red = qn + BT;             // [THREADS / 32]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int j0 = blockIdx.x * BT, i0 = blockIdx.y * BT, h = blockIdx.z;
  const float sc = scale[h];
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  float dsc = 0.f;
  for (int b = 0; b < Bn; ++b) {
    const WinMask W = win_mask(G, mask, b);
    __syncthreads();
    stage_query<T, TO>(q, g, lr_g, tt_g, G, b, h, i0, Qs, Gs, lr, tt, qn);
    stage_key<T>(k, v, G, b, h, j0, Ks, Vs, nullptr);
    __syncthreads();
    float p[4][4], ds[4][4], s[4][4];
    p_ds_tile(Qs, Gs, Ks, Vs, lr, tt, bias, sc, G, W, h, i0, j0, p, ds, s);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][c] += ds[a][c];
        dsc += ds[a][c] * s[a][c];
      }
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
  dsc = warp_sum(dsc);
  if (tid % 32 == 0) red[tid / 32] = dsc;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) tot += red[w];
    part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * G.H + h] = tot;
  }
}

constexpr size_t TILE_F = (size_t)BT * LD;
constexpr size_t SQ_F = (size_t)BT * LDS;
constexpr size_t SMEM_FWD = (3 * TILE_F + SQ_F + BT) * 4;
constexpr size_t SMEM_ROW = (4 * TILE_F + BT) * 4;
constexpr size_t SMEM_DQ = (4 * TILE_F + SQ_F + 3 * BT) * 4;
constexpr size_t SMEM_DKV = (4 * TILE_F + 2 * SQ_F + 4 * BT) * 4;
constexpr size_t SMEM_DB = (4 * TILE_F + 3 * BT + THREADS / 32) * 4;

template <typename F>
cudaError_t allow_smem(F fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct FwdArgs {
  const void *q, *k, *v, *bias, *scale, *mask;
  void* out;
};

template <typename T, typename TO>
int launch_fwd(const FwdArgs& A, int Bn, const Geo& G, cudaStream_t stream) {
  cudaError_t err = allow_smem(attn_fwd<T, TO>, SMEM_FWD);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (G.N + BT - 1) / BT;
  attn_fwd<T, TO><<<dim3(nt, G.H, Bn), THREADS, SMEM_FWD, stream>>>(
      static_cast<const T*>(A.q), static_cast<const T*>(A.k),
      static_cast<const T*>(A.v), static_cast<const float*>(A.bias),
      static_cast<const float*>(A.scale), static_cast<const float*>(A.mask),
      static_cast<TO*>(A.out), G);
  return static_cast<int>(cudaGetLastError());
}

struct BwdArgs {
  const void *q, *k, *v, *bias, *scale, *mask, *g;
  void *dq, *dk, *dv, *dbias, *dscale, *lr, *tt, *part;
};

template <typename T, typename TO>
int launch_bwd(const BwdArgs& A, int Bn, const Geo& G, cudaStream_t stream) {
  cudaError_t err;
  if ((err = allow_smem(bwd_rowstats<T, TO>, SMEM_ROW)) != cudaSuccess ||
      (err = allow_smem(bwd_dq<T, TO>, SMEM_DQ)) != cudaSuccess ||
      (err = allow_smem(bwd_dkv<T, TO>, SMEM_DKV)) != cudaSuccess ||
      (err = allow_smem(bwd_dbias<T, TO>, SMEM_DB)) != cudaSuccess)
    return static_cast<int>(err);
  const int nt = (G.N + BT - 1) / BT;
  const T* q = static_cast<const T*>(A.q);
  const T* k = static_cast<const T*>(A.k);
  const T* v = static_cast<const T*>(A.v);
  const float* bi = static_cast<const float*>(A.bias);
  const float* sc = static_cast<const float*>(A.scale);
  const float* mk = static_cast<const float*>(A.mask);
  const TO* g = static_cast<const TO*>(A.g);
  float* lr = static_cast<float*>(A.lr);
  float* tt = static_cast<float*>(A.tt);
  float* part = static_cast<float*>(A.part);
  const dim3 rows(nt, G.H, Bn);
  bwd_rowstats<T, TO><<<rows, THREADS, SMEM_ROW, stream>>>(q, k, v, bi, sc, mk,
                                                           g, lr, tt, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dq<T, TO><<<rows, THREADS, SMEM_DQ, stream>>>(
      q, k, v, bi, sc, mk, g, lr, tt, static_cast<TO*>(A.dq), G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dkv<T, TO><<<rows, THREADS, SMEM_DKV, stream>>>(
      q, k, v, bi, sc, mk, g, lr, tt, static_cast<TO*>(A.dk),
      static_cast<TO*>(A.dv), G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dbias<T, TO><<<dim3(nt, nt, G.H), THREADS, SMEM_DB, stream>>>(
      q, k, v, bi, sc, mk, g, lr, tt, static_cast<float*>(A.dbias), part, Bn,
      G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<(G.H + 127) / 128, 128, 0, stream>>>(
      part, static_cast<float*>(A.dscale), nt * nt, (size_t)G.H);
  return static_cast<int>(cudaGetLastError());
}

// geo: N, H, ws, shift, nWh, nWw, nWmask, round_ops, round_p, map, Hp, Wp
Geo make_geo(const int* geo) {
  Geo G{};
  G.N = geo[0]; G.H = geo[1]; G.ws = geo[2]; G.shift = geo[3];
  G.nWh = geo[4]; G.nWw = geo[5]; G.nWmask = geo[6];
  G.round_ops = geo[7]; G.round_p = geo[8];
  const int map = geo[9], Hp = geo[10], Wp = geo[11];
  const long long hd = 32;
  if (map) {
    G.in = Lay{1, G.ws, G.nWw, G.nWh * G.nWw, Hp, Wp, 3 * G.H * hd, hd, 0};
    G.out = Lay{1, G.ws, G.nWw, G.nWh * G.nWw, Hp, Wp, G.H * hd, hd, 0};
  } else {
    G.in = Lay{0, 0, 0, 0, 0, 0, hd, G.N * hd, G.H * G.N * hd};
    G.out = G.in;
  }
  return G;
}

}  // namespace

// K8 (map = 0: q, k, v, out [Bn, H, N, 32]) and K7 (map = 1: q, k, v point
// at the three parts of qkv [B, Hp, Wp, 3, H, 32], out [B, Hp, Wp, H, 32],
// Bn = B * nWh * nWw). `geo` holds the twelve integers of `make_geo`.
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* scale,
                                    const void* mask, void* out, int in_bf16,
                                    int out_bf16, int Bn, const int* geo,
                                    void* stream) {
  const Geo G = make_geo(geo);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs A{q, k, v, bias, scale, mask, out};
  if (in_bf16 && out_bf16) return launch_fwd<__nv_bfloat16, __nv_bfloat16>(A, Bn, G, s);
  if (in_bf16) return launch_fwd<__nv_bfloat16, float>(A, Bn, G, s);
  if (!out_bf16) return launch_fwd<float, float>(A, Bn, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8b and K7b. g has out's layout and type; dq, dk, dv have q's layout and
// out's type. Scratch: lr and tt [Bn, H, N] fp32, part ceil(N/64)^2 * H fp32.
extern "C" int window_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* scale, const void* mask, const void* g, void* dq, void* dk,
    void* dv, void* dbias, void* dscale, void* lr, void* tt, void* part,
    int in_bf16, int out_bf16, int Bn, const int* geo, void* stream) {
  const Geo G = make_geo(geo);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs A{q, k, v, bias, scale, mask, g, dq, dk, dv,
                  dbias, dscale, lr, tt, part};
  if (in_bf16 && out_bf16) return launch_bwd<__nv_bfloat16, __nv_bfloat16>(A, Bn, G, s);
  if (in_bf16) return launch_bwd<__nv_bfloat16, float>(A, Bn, G, s);
  if (!out_bf16) return launch_bwd<float, float>(A, Bn, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
