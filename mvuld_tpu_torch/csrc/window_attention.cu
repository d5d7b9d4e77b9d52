// K1/K2/K5: SwinV2 flat-layout cosine window attention, forward and its two
// backwards; K8/K8b: the same attention in the head layout; K7/K7b: read
// straight from the feature map.
//
// They replace the Pallas TPU kernels `pallas_window_attention_flat` (K1),
// `pallas_window_attention_flat_bwd2` (K2), `pallas_window_attention_flat_bwd`
// (K5), `pallas_window_attention` (K8), `pallas_window_attention_bwd` (K8b),
// `pallas_window_attention_map` (K7) and `pallas_window_attention_map_bwd`
// (K7b) of mvuld_tpu/ops/window_attention.py. Per window b and head h:
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
// One set of kernels serves the layouts: a layout descriptor (`Lay`) turns
// (window, head, token) into an address, so the head layout reads q, k, v
// [Bn, H, N, hd] and the map layout reads the window's tokens in place from
// qkv [B, Hp, Wp, 3, H, hd] and writes [B, Hp, Wp, H, hd] (dqkv in qkv's
// layout). The mask is either an operand [nW, N, N], read at b % nW (K8), or
// synthesised from the window's grid coordinates (K7: tokens of a window in
// the last window row / column of the rolled map attend only within their
// shift region, -100 otherwise), or absent.
//
// Every kernel runs on the bf16 tensor cores (attn_mma.cuh). What bounds the
// work: at SwinV2-Base-448's stage 1 (Bn 256, H 4, N 784), summed over the
// windows and heads, the forward's 4*N^2*hd flops are 0.08 ms of the tensor
// cores, the backward's 10*N^2*hd 0.2 ms, one exp per logit 0.15 ms of the
// special-function units, the operands 0.05-0.13 ms of device memory; what
// the kernels really pay is the per-logit work around the products (bias
// and mask reads from L2, the exp, the bf16 splits) and the copies of
// operand tiles into shared memory. The design:
//   - a preparation kernel (`prep_forward`, `prep_operands`) normalises q
//     and k in fp32 and writes every product operand once as bf16 terms in
//     the head layout, whatever the input layout and type. With `round_ops`
//     (`mxu_bf16`) only the first term of each is used, one MMA per product:
//     operands rounded to bf16, sums fp32, the TPU kernel's bf16 MXU
//     arithmetic. Otherwise the operands are split: q^ and k^ into three
//     terms and six MMAs per logit product (their error is multiplied by
//     the scale, up to 100, ahead of the exp), p, e, ds, and v, g where they
//     are fp32, into two terms and three MMAs; v and g that already are
//     bf16 have one term.
//   - one pass over the logits per reduction. Each pass forms s (and in the
//     backward dp) of a 16 x 16 block with `mma.sync.m16n8k16`, keeps p (e,
//     ds) in the accumulator registers, and feeds them, packed to bf16,
//     straight back as the A fragment of the second product: no tile of
//     logits passes through shared memory and no sum needs an atomic.
//     The forwards: K1's fixed-shift softmax is one pass (e = 2^(x log2e -
//     m_h log2e), sum e in registers, out = (e.v) * r with r = 1 / max(sum
//     e, 1e-30)); the exact softmax (K7, K8) a row pass that writes lr2 =
//     -(row max + log2 of the row sum) in log2 units, then an output pass
//     that forms p = 2^(x log2e + lr2) and adds p.v. p is normalised before
//     the second product because the bf16 variants round p itself (K8
//     rounds p to v's type, `mxu_bf16` every operand), and a rounded
//     unnormalised exp would not be that number. The backwards: row
//     statistics (lr2 and t = sum(dp * p)), dq over the keys, dk/dv over
//     the queries, dbias and dscale over the windows; dq and dk/dv are two
//     kernels because the second product of one needs the block the other
//     holds transposed (the dk/dv pass forms s^T). K2 merges them where a
//     window side's blocks fit in one thread-block cluster (N <= 1024, all
//     of SwinV2's windows): `attn_bwd_fused` forms s^T and dp^T of each
//     block once (the dk/dv pass's work: 24 + 4 MMAs for s and dp, 8 for
//     p.g, 12 for ds.q^, one exp and one bias read per logit), stages ds^T
//     as bf16 terms in shared memory and adds ds.k^ (12 more MMAs) for the
//     block's keys; the blocks' dq shares are added through distributed
//     shared memory in block order, so dq needs no atomics and no scratch.
//     60 MMAs a 16 x 16 block where the two passes took 88, and half the
//     exps, bias reads and operand loads. On the H100 at SwinV2-B's shapes
//     it takes 0.85-0.89 of the two passes' time (PERF.md): its main loop
//     alone runs as fast as the dk/dv pass, and the dq product, the
//     cluster's placement and its per-tile barrier with the owner's sum add
//     about 0.6 of that.
//   - a block owns 16 W rows of a window and head, W warps of 16 rows, the
//     ceil(N / 16) strips spread evenly over the fewest blocks of at most
//     8 warps: N = 784 is 7 blocks of 7 warps, N = 196 two of 7 (13
//     strips), N = 49 one of 4, and the walk over the other side goes in
//     steps of 16 up to ceil16(N), so nothing is ragged beyond N's own
//     last strip. Tiles of 64 rows arrive through `cp.async`, double
//     buffered; rows are 80 bytes apart so `ldmatrix` has no bank conflict.
//   - the mask costs no per-logit integer work: band flags per token (in
//     the shift band's columns / rows) are staged once per block and a
//     logit compares two flags under the window's mask; bias and a mask
//     operand are read as 8-byte pairs along the keys, one 16 x 16 block
//     ahead of their use.
//   - dbias is summed over windows in accumulator fragments by a block that
//     owns a 16 W x 64 tile of one head (its bias in registers) and walks
//     a chunk of the windows in order; chunks and dscale's per-block sums
//     are added by `sum_partials` in a fixed order, so two runs and the two
//     layouts give the same bits.
//
// The flat layout (K1, K2, K5) is a third `Lay`: a head layout whose token
// stride is qkv's row of 3C values (q, k, v at offsets 0, C, 2C; dq, dk, dv
// at the same offsets of dqkv) and C for out, o and g, with the shift mask
// synthesised as K7's. Its softmax subtracts a fixed per-head shift m_h =
// scale_h + max(bias[h]) in place of the row maximum, so its p has the
// same form, p = 2^(x log2e + lr2) with lr2 = log2 r - m_h log2e, and the
// passes after the row statistics are the exact softmax's. Only the row
// terms differ: K2 reads r (K1 writes it) and rowsum(g * o) from the
// forward, and `prep_operands` turns them into lr2 and t once per row;
// K5 runs a fixed-shift row pass (ROWSUMS: sums of e = p at lr2 = -m_h
// log2e and of e * dp, no maximum) that writes lr2 and t' = r * sum(e dp)
// with r = 1 / max(sum e, 1e-30), never r^2 (r may reach 1e30).
// `mxu_bf16` is `round_ops` here too. Head dim 32 (SwinV2's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "attn_mma.cuh"
#include "common.cuh"

namespace {

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

// ------------------------------------------------------ shared by the passes
//
// Every kernel below works on the helpers of attn_mma.cuh. A preparation
// kernel (`prep_forward`, `prep_operands`) normalises q and k in fp32 and
// writes every product operand once as bf16 terms in the head layout, so
// the passes after it copy tiles with `cp.async` and do no staging
// arithmetic.

constexpr int TK = 64;     // other-side rows per tile
constexpr int TJ = 64;     // key columns of a dbias tile
constexpr int MAXW = 8;    // warps per block at most
constexpr int PX = 3;      // terms of q^ and k^ (six products per logit)
// the passes of attn_bwd_rows: row statistics of the exact softmax, of the
// fixed-shift softmax, dq, dk and dv
enum { ROWSTATS = 0, DQ = 1, DKV = 2, ROWSUMS = 3 };
// where a backward takes its row terms lr2 and t from: the exact row pass
// (K8b, K7b), the forward's r and output (K2), the fixed-shift row pass (K5)
enum { EXACT_ROWS = 0, FORWARD_ROWS = 1, FIXED_ROWS = 2 };

// bf16 terms of a product operand of this type
template <typename T> struct Terms { static constexpr int n = 2; };
template <> struct Terms<__nv_bfloat16> { static constexpr int n = 1; };

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The staged operands: term p of each at + p * stride, rows [Bn, H, N] of
// 32 bf16 back to back; qn, kn [Bn, H, N] the normalisation factors.
struct Staged {
  __nv_bfloat16 *q, *k, *v, *g;
  size_t stride;
  float *qn, *kn;
};

// The logit source: x = s_cos * scale + (bias + mask), p = 2^(x log2e +
// lr2) with lr2 = -(row max + log2 of the row sum) in log2 units for the
// exact softmax and lr2 = log2 r - m_h log2e for the fixed shift (the two
// differ in their row terms only). The synthesised shift mask compares
// per-token band flags (1: column in the shift band, 2: row in it) under
// the window's `wm` (1: last window column, 2: last window row; 0: no
// mask), so a logit costs an xor and a test, no division.
struct Logits {
  const float* bias;            // bias[h]
  const float* mask;            // this window's mask operand, or null
  const unsigned char* flags;   // [N16] in shared memory
  float sc;
  int N, wm;

  // `from` ([N, N]) at the accumulator quad (ra, c), (ra, c+1), (rb, c),
  // (rb, c+1). KEYROWS: rows are keys and columns queries (the transposed
  // block). Rows and columns past N read a clamped address.
  template <bool KEYROWS>
  __device__ __forceinline__ void fetch(const float* from, int ra, int rb, int c,
                                        float (&a)[4]) const {
    const int rac = min(ra, N - 1), rbc = min(rb, N - 1);
    if (!KEYROWS && !(N & 1)) {           // two neighbouring keys: 8-byte loads
      const int cc = min(c, N - 2);
      const float2 u = *reinterpret_cast<const float2*>(from + (size_t)rac * N + cc);
      const float2 w = *reinterpret_cast<const float2*>(from + (size_t)rbc * N + cc);
      a[0] = u.x; a[1] = u.y; a[2] = w.x; a[3] = w.y;
    } else {
      const int c0 = min(c, N - 1), c1 = min(c + 1, N - 1);
      if (KEYROWS) {
        a[0] = from[(size_t)c0 * N + rac]; a[1] = from[(size_t)c1 * N + rac];
        a[2] = from[(size_t)c0 * N + rbc]; a[3] = from[(size_t)c1 * N + rbc];
      } else {
        a[0] = from[(size_t)rac * N + c0]; a[1] = from[(size_t)rac * N + c1];
        a[2] = from[(size_t)rbc * N + c0]; a[3] = from[(size_t)rbc * N + c1];
      }
    }
  }

  // bias + mask operand of the quad: what a logit adds to s_cos * scale
  template <bool KEYROWS>
  __device__ __forceinline__ void addends(int ra, int rb, int c, float (&a)[4]) const {
    fetch<KEYROWS>(bias, ra, rb, c, a);
    if (mask != nullptr) {
      float m[4];
      fetch<KEYROWS>(mask, ra, rb, c, m);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] += m[e];
    }
  }

  // the quad's logits from its s_cos and addends; fa, fb the rows' band
  // flags; with `edge` a column past N gives -inf (p = 0)
  __device__ __forceinline__ void logits(int c, int fa, int fb, const float (&s)[4],
                                         const float (&a)[4], float (&x)[4],
                                         bool edge) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = fmaf(s[e], sc, a[e]);
    if (wm != 0) {
      const int f0 = flags[c], f1 = flags[c + 1];
      if ((fa ^ f0) & wm) x[0] += -100.f;
      if ((fa ^ f1) & wm) x[1] += -100.f;
      if ((fb ^ f0) & wm) x[2] += -100.f;
      if ((fb ^ f1) & wm) x[3] += -100.f;
    }
    if (edge) {
      if (c >= N) x[0] = x[2] = -CUDART_INF_F;
      if (c + 1 >= N) x[1] = x[3] = -CUDART_INF_F;
    }
  }

  __device__ __forceinline__ float p(float x, float lr2) const {
    return fast_exp2(fmaf(x, LOG2E, lr2));
  }
};

// band flags of every token of a window (zero when no mask is synthesised)
__device__ __forceinline__ void stage_flags(const Geo& G, bool synth, int N16,
                                            unsigned char* flags) {
  for (int i = threadIdx.x; i < N16; i += blockDim.x) {
    int f = 0;
    if (synth && i < G.N)
      f = (i % G.ws >= G.ws - G.shift ? 1 : 0) | (i / G.ws >= G.ws - G.shift ? 2 : 0);
    flags[i] = static_cast<unsigned char>(f);
  }
}

__device__ __forceinline__ int window_bands(const Geo& G, bool synth, int b) {
  if (!synth) return 0;
  const int wid = b % (G.nWh * G.nWw);
  return (wid % G.nWw == G.nWw - 1 ? 1 : 0) | (wid / G.nWw == G.nWh - 1 ? 2 : 0);
}

// ---------------------------------------------------------------- forward
//
// `prep_forward` writes the forward's product operands; each `attn_fwd_*`
// pass is a block of W warps that owns 16 W query rows of one window and
// head (`plan_rows`), keeps their q^ fragments in registers and walks the
// key tiles (k^ and v, double buffered) 16 keys at a time: s of a 16 x 16
// block on the tensor cores, its logits and p (or e) in the accumulator
// registers and, but in the row pass, p.v from those registers into a
// 16 x 32 fp32 accumulator per warp.

// the forward passes: the exact softmax's row statistics (lr2) and its
// output; the fixed-shift softmax's output and row sums in one pass
enum { FWD_STATS = 0, FWD_OUT = 1, FWD_FLAT = 2 };

template <typename TO>
struct FwdP {
  Staged S;                  // q^, k^, v (g and the norms unused)
  const float *bias, *scale, *mask, *shiftm;
  float* lr;                 // [Bn, H, N]: lr2, written by FWD_STATS
  float* r;                  // [Bn, H, N]: K1's 1 / max(sum e, 1e-30), or null
  TO* out;
};

// One thread per eight values of a (window, head, token) row: q^ and k^ as
// PX terms, v as one (bf16) or two (fp32), in the head layout.
template <typename T>
__global__ void __launch_bounds__(256) prep_forward(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    Staged S, int Bn, Geo G) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = idx >> 2, total = (size_t)Bn * G.H * G.N;
  const int c = static_cast<int>(idx & 3);
  const bool in = row < total;          // whole quads; the shuffles need all
  const size_t rr = in ? row : 0;
  const int i = static_cast<int>(rr % G.N), h = static_cast<int>(rr / G.N % G.H);
  const int b = static_cast<int>(rr / G.N / G.H);
  const size_t src = at(G.in, b, h, i) + 8 * c, dst = rr * HD + 8 * c;
  float x[8];
  load8(q + src, x);
  normalise8(x);
  if (in) store_terms<PX>(x, S.q + dst, S.stride);
  load8(k + src, x);
  normalise8(x);
  if (!in) return;
  store_terms<PX>(x, S.k + dst, S.stride);
  load8(v + src, x);
  store_terms<Terms<T>::n>(x, S.v + dst, S.stride);
}

// The body of the three passes. PV: the terms of v. FWD_STATS writes lr2 =
// -(row max + log2 of the row sum) in log2 units; FWD_OUT forms p = 2^(x
// log2e + lr2) and writes p.v; FWD_FLAT forms e = 2^(x log2e - m_h log2e)
// (m_h bounds every logit: no maximum) and writes (e.v) * r with r = 1 /
// max(sum e, 1e-30), and r itself when A.r is given. p (e) takes two terms
// unless `round_p`, v two when it is fp32 unless `round_ops`; out is
// written at G.out. Grid (own tiles, H, Bn), 32 W threads.
template <int PV, typename TO, int MODE>
__device__ __forceinline__ void fwd_rows(const FwdP<TO>& A, const Geo& G) {
  constexpr int PY = MODE == FWD_STATS ? 0 : PV;     // terms of v in a key tile
  extern __shared__ __align__(16) unsigned char smem[];

  const int W = blockDim.x >> 5, R = 16 * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  // with a mask operand, neighbouring blocks take the windows that share a
  // mask slice (window z % images of slice z / images), so it stays in L2
  const int images = G.nWmask > 0 ? gridDim.z / G.nWmask : 1;
  const int b = G.nWmask > 0 ? (blockIdx.z % images) * G.nWmask + blockIdx.z / images
                             : blockIdx.z;
  const int h = blockIdx.y, own0 = blockIdx.x * R;
  const int N = G.N, N16 = (N + 15) & ~15;
  const int so = R * LDB, st = TK * LDB;
  constexpr int OTH = (PX + PY) * TK * LDB;        // one key tile: k^, then v
  __nv_bfloat16* ownX = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* oth = ownX + PX * so;             // [2][OTH]
  unsigned char* flags = reinterpret_cast<unsigned char*>(oth + 2 * OTH);

  const bool split = !G.round_ops, p_split = !G.round_p;
  const bool synth = A.mask == nullptr && G.shift > 0;
  const int nx = split ? PX : 1, ny = split ? PY : 1;
  const float sc = A.scale[h];
  const size_t row0 = ((size_t)b * G.H + h) * N;
  const Staged& S = A.S;
  const __nv_bfloat16* kx = S.k + row0 * HD;
  const __nv_bfloat16* vy = S.v + row0 * HD;

  auto fetch_tile = [&](int t) {
    const int o0 = t * TK, rows = min(TK, N16 - o0);
    __nv_bfloat16* buf = oth + (t & 1) * OTH;
    copy_rows_async<PX>(kx, S.stride, nx, o0, rows, N, buf, st);
    if constexpr (PY > 0) copy_rows_async<PY>(vy, S.stride, ny, o0, rows, N, buf + PX * st, st);
  };

  copy_rows_async<PX>(S.q + row0 * HD, S.stride, PX, own0, R, N, ownX, so);
  fetch_tile(0);
  cp_async_commit();
  stage_flags(G, synth, N16, flags);

  const Logits LG{A.bias + (size_t)h * N * N,
                  A.mask == nullptr ? nullptr : A.mask + (size_t)(b % G.nWmask) * N * N,
                  flags, sc, N, window_bands(G, synth, b)};
  const bool active = own0 + 16 * warp < N;     // else a strip of padding
  const int ra = own0 + 16 * warp + g8, rb = ra + 8;
  uint32_t ax[PX][2][4];
  int fa = 0, fb = 0;
  // what p adds to x log2e: FWD_OUT the rows' lr2 (p = 0 past N), FWD_FLAT
  // -m_h log2e (K5's row pass forms the same e)
  float lr[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if constexpr (MODE == FWD_FLAT) lr[0] = lr[1] = -A.shiftm[h] * LOG2E;
  float add_next[2][4];
  if (active) {
    if constexpr (MODE == FWD_OUT) {
      if (ra < N) lr[0] = A.lr[row0 + ra];
      if (rb < N) lr[1] = A.lr[row0 + rb];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) LG.addends<false>(ra, rb, 8 * nt + 2 * t4, add_next[nt]);
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};

  const int ntiles = (N16 + TK - 1) / TK;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) fetch_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile t (and the own rows) have landed
    __syncthreads();
    if (t == 0 && active) {
#pragma unroll
      for (int p = 0; p < PX; ++p) load_a(ax[p], ownX + p * so, 16 * warp);
      fa = flags[ra];
      fb = flags[rb];
    }
    const int o0 = t * TK, rows = min(TK, N16 - o0);
    const __nv_bfloat16* othX = oth + (t & 1) * OTH;
    const __nv_bfloat16* othY = othX + PX * st;

    for (int sub = 0; active && sub < rows; sub += 16) {
      float s[2][4], x[2][4], add[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) add[nt][e] = add_next[nt][e];
        // the next 16 columns' addends, in flight during this block's MMAs
        LG.addends<false>(ra, rb, o0 + sub + 16 + 8 * nt + 2 * t4, add_next[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        mma_terms_nk<PX, PX>(s[nt], ax, othX, st, sub + 8 * nt, split);
      }
      const bool edge = o0 + sub + 16 > N;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        LG.logits(o0 + sub + 8 * nt + 2 * t4, fa, fb, s[nt], add[nt], x[nt], edge);

      if constexpr (MODE == FWD_STATS) {
        // this thread's four columns of each row: a running maximum (in
        // log2 units) and the sum of 2^(y - max)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float y0 = x[0][2 * r] * LOG2E, y1 = x[0][2 * r + 1] * LOG2E;
          const float y2 = x[1][2 * r] * LOG2E, y3 = x[1][2 * r + 1] * LOG2E;
          const float tmax = fmaxf(fmaxf(y0, y1), fmaxf(y2, y3));
          if (tmax > m[r]) {
            l[r] *= fast_exp2(m[r] - tmax);
            m[r] = tmax;
          }
          l[r] += (fast_exp2(y0 - m[r]) + fast_exp2(y1 - m[r])) +
                  (fast_exp2(y2 - m[r]) + fast_exp2(y3 - m[r]));
        }
      } else {
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[nt][e] = LG.p(x[nt][e], lr[e >> 1]);
        if constexpr (MODE == FWD_FLAT) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            l[r] += (p[0][2 * r] + p[0][2 * r + 1]) + (p[1][2 * r] + p[1][2 * r + 1]);
        }
        uint32_t hi[4], lo[4];
        acc_to_a(p, hi, lo);
        mma_terms_kn<PY>(acc, hi, lo, othY, st, sub, p_split, split);
      }
    }
    __syncthreads();                  // tile t is consumed
  }
  if (!active) return;

  float f[2] = {1.f, 1.f};            // what the output rows are multiplied by
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r == 0 ? ra : rb;
    if constexpr (MODE == FWD_STATS) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {     // the row's four threads
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float mn = fmaxf(m[r], mo);
        l[r] = l[r] * fast_exp2(m[r] - mn) + lo * fast_exp2(mo - mn);
        m[r] = mn;
      }
      if (t4 == 0 && i < N) A.lr[row0 + i] = -(m[r] + log2f(l[r]));
    } else if constexpr (MODE == FWD_FLAT) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      f[r] = 1.f / fmaxf(l[r], 1e-30f);
      if (A.r != nullptr && t4 == 0 && i < N) A.r[row0 + i] = f[r];
    }
  }
  if constexpr (MODE != FWD_STATS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r == 0 ? ra : rb;
      if (i >= N) continue;
      TO* out = A.out + at(G.out, b, h, i);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store2(out + 8 * nt + 2 * t4, acc[nt][2 * r] * f[r], acc[nt][2 * r + 1] * f[r]);
    }
  }
}

// the passes as kernels of their own names (profiles tell them apart)
template <typename TO>
__global__ void __launch_bounds__(32 * MAXW, 2) attn_fwd_stats(FwdP<TO> A, Geo G) {
  fwd_rows<1, TO, FWD_STATS>(A, G);
}
template <int PV, typename TO>
__global__ void __launch_bounds__(32 * MAXW, 2) attn_fwd_out(FwdP<TO> A, Geo G) {
  fwd_rows<PV, TO, FWD_OUT>(A, G);
}
template <int PV, typename TO>
__global__ void __launch_bounds__(32 * MAXW, 2) attn_fwd_flat(FwdP<TO> A, Geo G) {
  fwd_rows<PV, TO, FWD_FLAT>(A, G);
}

// --------------------------------------------------------------- backward
//
// Six kernels. `prep_operands` writes q^, k^ (three terms), v and g (one
// or two). `attn_bwd_rows` serves three of them: a block owns 16 W "own"
// rows of one window and head (W warps, 16 rows each: queries for
// ROWSTATS, ROWSUMS and DQ, keys for DKV), keeps their A fragments in
// registers and walks the other side in double-buffered tiles of TK rows,
// 16 at a time: s and dp of a 16 x 16 block on the tensor cores, the
// logits and p, ds in registers, and the second products straight from
// those registers. `attn_bwd_sums` owns a 16 W x TJ tile of one head and
// walks a range of windows. K2 runs `attn_bwd_fused` in place of the DQ
// and DKV passes wherever its clusters fit (below).

// K2's row terms from the forward: its output o (out's layout and type),
// its reciprocal row sums r [Bn, H, N] and the fixed shifts m [H]; null
// pointers for every other backward.
template <typename TO>
struct FwdRows {
  const TO* o;
  const float *r, *shiftm;
};

// One thread per eight values of a (window, head, token) row. With F.o, it
// also writes the row's lr2 = log2 r - m_h log2e and t = rowsum(g * o),
// summed in fp32 from o and g in their own type (lr, tt [Bn, H, N]).
template <typename T, typename TO>
__global__ void __launch_bounds__(256) prep_operands(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const TO* __restrict__ g, Staged S, int Bn, Geo G, FwdRows<TO> F,
    float* __restrict__ lr, float* __restrict__ tt) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = idx >> 2, total = (size_t)Bn * G.H * G.N;
  const int c = static_cast<int>(idx & 3);
  const bool in = row < total;          // whole quads; the shuffles need all
  const size_t rr = in ? row : 0;
  const int i = static_cast<int>(rr % G.N), h = static_cast<int>(rr / G.N % G.H);
  const int b = static_cast<int>(rr / G.N / G.H);
  const size_t src = at(G.in, b, h, i) + 8 * c, dst = rr * HD + 8 * c;
  const size_t gsrc = at(G.out, b, h, i) + 8 * c;
  float x[8];
  load8(q + src, x);
  float n = normalise8(x);
  if (in) {
    store_terms<PX>(x, S.q + dst, S.stride);
    if (c == 0) S.qn[rr] = n;
  }
  load8(k + src, x);
  n = normalise8(x);
  float t = 0.f;
  if (F.o != nullptr) {
    float gv[8], ov[8];
    load8(g + gsrc, gv);
    load8(F.o + gsrc, ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) t += gv[e] * ov[e];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
  }
  if (!in) return;
  store_terms<PX>(x, S.k + dst, S.stride);
  if (c == 0) S.kn[rr] = n;
  load8(v + src, x);
  store_terms<Terms<T>::n>(x, S.v + dst, S.stride);
  load8(g + gsrc, x);
  store_terms<Terms<TO>::n>(x, S.g + dst, S.stride);
  if (F.o != nullptr && c == 0) {
    lr[rr] = fmaf(-F.shiftm[h], LOG2E, log2f(F.r[rr]));
    tt[rr] = t;
  }
}

template <typename TO>
struct BwdP {
  Staged S;
  const float *bias, *scale, *mask;
  float *lr, *tt;            // [Bn, H, N]: lr2 and t = sum(dp * p)
  TO *dq, *dk, *dv;
};

// K2's and K5's parameters: BwdP and two more. A separate type, because a
// larger parameter block changes nvcc's code for K8b/K7b's passes (1-2 %
// slower on the card) although they never read the two.
template <typename TO>
struct FlatBwdP : BwdP<TO> {
  const float* shiftm;       // [H]: the fixed shift m_h (ROWSUMS)
  // [Bn, H, N]: K2's dscale terms q^ . dq^ / scale per query row (the DQ
  // pass writes them, the sums pass adds them in place of ds * s; ROWQ)
  float* rowq;
};

// The gradient of the normalised rows back through x^ = x * rsqrt(sum x^2):
// out = (acc*sc - x^ (x^ . acc*sc)) * n for the warp's rows rl (quad row g)
// and rl + 8 of the block's own tile, x^ summed from its staged terms, n
// the rows' factors; dots gets the two rows' x^ . acc*sc. A null pointer
// skips that row's store.
template <typename TO>
__device__ __forceinline__ void store_normalised(const float (&acc)[4][4], float sc,
                                                 const __nv_bfloat16* ownX, int so,
                                                 int rl, float na, float nb,
                                                 TO* out_a, TO* out_b,
                                                 float (&dots)[2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rl + 8 * r;
    float2 xv[4];
    float dot = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      xv[nt] = staged_pair<PX>(ownX, so, row, 8 * nt + 2 * t4);
      dot += xv[nt].x * (acc[nt][2 * r] * sc) + xv[nt].y * (acc[nt][2 * r + 1] * sc);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dots[r] = dot;
    const float n = r == 0 ? na : nb;
    TO* out = r == 0 ? out_a : out_b;
    if (out == nullptr) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      store2(out + 8 * nt + 2 * t4, (acc[nt][2 * r] * sc - xv[nt].x * dot) * n,
             (acc[nt][2 * r + 1] * sc - xv[nt].y * dot) * n);
  }
}

// ROWSTATS (exact softmax) and ROWSUMS (fixed shift): lr2 and t of the
// block's query rows. DQ: dq of them (with ROWQ also K2's dscale terms
// A.rowq). DKV: dk and dv of the block's key rows. PV, PG: the terms of v
// and g. Grid (own tiles, H, Bn), 32 W threads. ROWQ is a template switch
// so that the other backwards compile without its code; P is BwdP<TO>, or
// FlatBwdP<TO> for ROWSUMS and ROWQ.
template <int PV, int PG, typename TO, int MODE, bool ROWQ, typename P>
__global__ void __launch_bounds__(32 * MAXW, 2) attn_bwd_rows(P A, Geo G) {
  constexpr bool KEYS = MODE == DKV;
  constexpr int PYO = KEYS ? PV : PG, PYT = KEYS ? PG : PV;   // own, other v or g
  extern __shared__ __align__(16) unsigned char smem[];

  const int W = blockDim.x >> 5, R = 16 * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  // with a mask operand, neighbouring blocks take the windows that share a
  // mask slice (window z % images of slice z / images), so it stays in L2
  const int images = G.nWmask > 0 ? gridDim.z / G.nWmask : 1;
  const int b = G.nWmask > 0 ? (blockIdx.z % images) * G.nWmask + blockIdx.z / images
                             : blockIdx.z;
  const int h = blockIdx.y, own0 = blockIdx.x * R;
  const int N = G.N, N16 = (N + 15) & ~15;
  const int so = R * LDB, st = TK * LDB;
  constexpr int OTH = (PX + PYT) * TK * LDB;       // one buffer of the other side
  __nv_bfloat16* ownX = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ownY = ownX + PX * so;
  __nv_bfloat16* oth = ownY + PYO * so;            // [2][OTH]: x terms, then y
  float* oth_lr = reinterpret_cast<float*>(oth + 2 * OTH);     // [2][TK]
  float* oth_tt = oth_lr + 2 * TK;                             // [2][TK]
  unsigned char* flags = reinterpret_cast<unsigned char*>(oth_tt + 2 * TK);

  const bool split = !G.round_ops, p_split = !G.round_p;
  const bool synth = A.mask == nullptr && G.shift > 0;
  const int nx = split ? PX : 1, nyo = split ? PYO : 1, nyt = split ? PYT : 1;
  const float sc = A.scale[h];
  const size_t row0 = ((size_t)b * G.H + h) * N;
  const Staged& S = A.S;
  const __nv_bfloat16* xo = (KEYS ? S.k : S.q) + row0 * HD;
  const __nv_bfloat16* xt = (KEYS ? S.q : S.k) + row0 * HD;
  const __nv_bfloat16* yo = (KEYS ? S.v : S.g) + row0 * HD;
  const __nv_bfloat16* yt = (KEYS ? S.g : S.v) + row0 * HD;

  auto fetch_tile = [&](int t) {
    const int o0 = t * TK, rows = min(TK, N16 - o0);
    __nv_bfloat16* buf = oth + (t & 1) * OTH;
    copy_rows_async<PX>(xt, S.stride, nx, o0, rows, N, buf, st);
    copy_rows_async<PYT>(yt, S.stride, nyt, o0, rows, N, buf + PX * st, st);
    if (KEYS) {
      for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        const bool in = o0 + i < N;
        const size_t at_i = row0 + (in ? o0 + i : 0);
        cp_async4(oth_lr + (t & 1) * TK + i, A.lr + at_i, in);
        cp_async4(oth_tt + (t & 1) * TK + i, A.tt + at_i, in);
      }
    }
  };

  // every term of the own x^: the epilogue rebuilds x^ from them
  copy_rows_async<PX>(xo, S.stride, PX, own0, R, N, ownX, so);
  copy_rows_async<PYO>(yo, S.stride, nyo, own0, R, N, ownY, so);
  fetch_tile(0);
  cp_async_commit();
  stage_flags(G, synth, N16, flags);

  const Logits LG{A.bias + (size_t)h * N * N,
                       A.mask == nullptr ? nullptr
                                         : A.mask + (size_t)(b % G.nWmask) * N * N,
                       flags, sc, N, window_bands(G, synth, b)};
  const bool active = own0 + 16 * warp < N;     // else a strip of padding
  const int ra = own0 + 16 * warp + g8, rb = ra + 8;
  uint32_t ax[PX][2][4], ay[PYO][2][4];
  int fa = 0, fb = 0;
  float lr[2] = {-CUDART_INF_F, -CUDART_INF_F}, tt[2] = {0.f, 0.f};   // p = 0 past N
  float add_next[2][4];
  if (active) {
    if (MODE == DQ) {
      if (ra < N) { lr[0] = A.lr[row0 + ra]; tt[0] = A.tt[row0 + ra]; }
      if (rb < N) { lr[1] = A.lr[row0 + rb]; tt[1] = A.tt[row0 + rb]; }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      LG.addends<KEYS>(ra, rb, 8 * nt + 2 * t4, add_next[nt]);
  }

  float acc1[4][4], acc2[4][4];       // DQ: dq^. DKV: dv, dk^
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[a][e] = acc2[a][e] = 0.f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, ts[2] = {0.f, 0.f};
  // ROWSUMS: e = p at lr2 = -m_h log2e, the fixed shift's unnormalised exp
  float lr0 = 0.f;
  if constexpr (MODE == ROWSUMS) lr0 = -A.shiftm[h] * LOG2E;

  const int ntiles = (N16 + TK - 1) / TK;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) fetch_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile t (and the own rows) have landed
    __syncthreads();
    if (t == 0 && active) {
#pragma unroll
      for (int p = 0; p < PX; ++p) load_a(ax[p], ownX + p * so, 16 * warp);
#pragma unroll
      for (int p = 0; p < PYO; ++p) load_a(ay[p], ownY + p * so, 16 * warp);
      fa = flags[ra];
      fb = flags[rb];
    }
    const int o0 = t * TK, rows = min(TK, N16 - o0);
    const __nv_bfloat16* othX = oth + (t & 1) * OTH;
    const __nv_bfloat16* othY = othX + PX * st;
    const float* tlr = oth_lr + (t & 1) * TK;
    const float* ttt = oth_tt + (t & 1) * TK;

    for (int sub = 0; active && sub < rows; sub += 16) {
      float s[2][4], dp[2][4], x[2][4], add[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) add[nt][e] = add_next[nt][e];
        // the next 16 columns' addends, in flight during this block's MMAs
        LG.addends<KEYS>(ra, rb, o0 + sub + 16 + 8 * nt + 2 * t4, add_next[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        mma_terms_nk<PX, PX>(s[nt], ax, othX, st, sub + 8 * nt, split);
        mma_terms_nk<PYO, PYT>(dp[nt], ay, othY, st, sub + 8 * nt, split);
      }
      const bool edge = o0 + sub + 16 > N;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        LG.logits(o0 + sub + 8 * nt + 2 * t4, fa, fb, s[nt], add[nt], x[nt], edge);

      if (MODE == ROWSTATS) {
        // this thread's four columns of each row: a running maximum (in
        // log2 units), the sum of 2^(y - max) and of that times dp
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float y0 = x[0][2 * r] * LOG2E, y1 = x[0][2 * r + 1] * LOG2E;
          const float y2 = x[1][2 * r] * LOG2E, y3 = x[1][2 * r + 1] * LOG2E;
          const float tmax = fmaxf(fmaxf(y0, y1), fmaxf(y2, y3));
          if (tmax > m[r]) {
            const float cf = fast_exp2(m[r] - tmax);
            l[r] *= cf;
            ts[r] *= cf;
            m[r] = tmax;
          }
          const float e0 = fast_exp2(y0 - m[r]), e1 = fast_exp2(y1 - m[r]);
          const float e2 = fast_exp2(y2 - m[r]), e3 = fast_exp2(y3 - m[r]);
          l[r] += (e0 + e1) + (e2 + e3);
          ts[r] += (e0 * dp[0][2 * r] + e1 * dp[0][2 * r + 1]) +
                   (e2 * dp[1][2 * r] + e3 * dp[1][2 * r + 1]);
        }
      } else if (MODE == ROWSUMS) {
        // this thread's four columns of each row: sum e and e * dp, no
        // maximum (m_h bounds every logit)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float e0 = LG.p(x[0][2 * r], lr0), e1 = LG.p(x[0][2 * r + 1], lr0);
          const float e2 = LG.p(x[1][2 * r], lr0), e3 = LG.p(x[1][2 * r + 1], lr0);
          l[r] += (e0 + e1) + (e2 + e3);
          ts[r] += (e0 * dp[0][2 * r] + e1 * dp[0][2 * r + 1]) +
                   (e2 * dp[1][2 * r] + e3 * dp[1][2 * r + 1]);
        }
      } else if (MODE == DQ) {
        float ds[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[nt][e] = LG.p(x[nt][e], lr[e >> 1]) * (dp[nt][e] - tt[e >> 1]);
        uint32_t hi[4], lo[4];
        acc_to_a(ds, hi, lo);
        mma_terms_kn<2>(acc1, hi, lo, othX, st, sub, split, split);
      } else {
        float p[2][4], ds[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = sub + 8 * nt + 2 * t4;
          const float2 lc = *reinterpret_cast<const float2*>(tlr + c);
          const float2 tc = *reinterpret_cast<const float2*>(ttt + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[nt][e] = LG.p(x[nt][e], (e & 1) ? lc.y : lc.x);
            ds[nt][e] = p[nt][e] * (dp[nt][e] - ((e & 1) ? tc.y : tc.x));
          }
        }
        uint32_t hi[4], lo[4];
        acc_to_a(p, hi, lo);
        mma_terms_kn<PYT>(acc1, hi, lo, othY, st, sub, p_split, split);
        acc_to_a(ds, hi, lo);
        mma_terms_kn<2>(acc2, hi, lo, othX, st, sub, split, split);
      }
    }
    __syncthreads();                  // tile t is consumed
  }
  if (!active) return;

  if (MODE == ROWSTATS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {     // the row's four threads
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float to = __shfl_xor_sync(0xffffffffu, ts[r], off);
        const float mn = fmaxf(m[r], mo);
        const float ca = fast_exp2(m[r] - mn), cb = fast_exp2(mo - mn);
        l[r] = l[r] * ca + lo * cb;
        ts[r] = ts[r] * ca + to * cb;
        m[r] = mn;
      }
      const int i = r == 0 ? ra : rb;
      if (t4 == 0 && i < N) {
        A.lr[row0 + i] = -(m[r] + log2f(l[r]));
        A.tt[row0 + i] = ts[r] / l[r];
      }
    }
  } else if (MODE == ROWSUMS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {     // the row's four threads
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
        ts[r] += __shfl_xor_sync(0xffffffffu, ts[r], off);
      }
      const int i = r == 0 ? ra : rb;
      if (t4 == 0 && i < N) {
        const float rs = 1.f / fmaxf(l[r], 1e-30f);   // K1's clamped row sum
        A.lr[row0 + i] = log2f(rs) + lr0;
        A.tt[row0 + i] = rs * ts[r];
      }
    }
  } else {
    const float* norm = KEYS ? S.kn : S.qn;
    TO* grad = KEYS ? A.dk : A.dq;
    float dots[2];
    store_normalised<TO>(KEYS ? acc2 : acc1, sc, ownX, so, 16 * warp + g8,
                         ra < N ? norm[row0 + ra] : 0.f,
                         rb < N ? norm[row0 + rb] : 0.f,
                         ra < N ? grad + at(G.in, b, h, ra) : nullptr,
                         rb < N ? grad + at(G.in, b, h, rb) : nullptr, dots);
    if constexpr (ROWQ) {
      if (t4 == 0 && ra < N) A.rowq[row0 + ra] = dots[0] / sc;
      if (t4 == 0 && rb < N) A.rowq[row0 + rb] = dots[1] / sc;
    }
    if (KEYS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r == 0 ? ra : rb;
        if (j >= N) continue;
        TO* out = A.dv + at(G.in, b, h, j);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          store2(out + 8 * nt + 2 * t4, acc1[nt][2 * r], acc1[nt][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------- K2's fused key-outer pass
//
// dq, dk and dv from one formation of each logit block (K2 only, where
// plan_rows gives at most MAXC blocks a window side). A block owns 16 W key
// rows of one window and head, as DKV does, and walks the query tiles TQ
// rows at a time: per 16-query step each warp forms s^T and dp^T of its 16
// keys once, derives p^T and ds^T from the query rows' lr2 and t, adds p^T.g
// into dv and ds^T.q^ into dk^, and writes ds^T (its hi and lo terms) to a
// shared tile. Once a tile is done the block's warps multiply that tile,
// read as ds through `ldmatrix.trans`, by the block's k^ (units of 16
// queries x 16 columns, the keys in order): the block's share of dq^. The
// blocks of one window and head are launched as one thread-block cluster;
// the tile's owner (tile t % blocks) adds every block's share in block
// order through distributed shared memory and runs DQ's epilogue (dq and
// rowq). No atomics and no scratch in device memory: two runs give the same
// bits. The cluster's barrier is split: a block arrives once its share of
// tile t is written and waits (then the owner adds) after it has formed
// tile t + 1, so the barrier's latency hides behind a tile's work; the
// owner reads its q^ for the epilogue before it waits.

constexpr int MAXC = 8;         // blocks of a cluster at most (the portable limit)
constexpr int TQ = 48;          // query rows per tile of the fused pass
constexpr int LDS = TQ + 8;     // bf16 per row of its ds^T tile: 112 bytes, so
                                // the rows of an ldmatrix fall in distinct banks

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The cluster's barrier in two halves: arrive releases this thread's
// writes; wait returns once every thread of the cluster has arrived, and
// acquires theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
// the float4 at `p` of this block's shared memory as block `rank` of the
// cluster holds it
__device__ __forceinline__ float4 load_cluster(const float* p, unsigned rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(ra)
               : "memory");
  return v;
}

// PV, PG: the terms of v and g. Grid (blocks, H, Bn) in clusters of
// (blocks, 1, 1), 32 W threads.
template <int PV, int PG, typename TO>
__global__ void __launch_bounds__(32 * MAXW, 2) attn_bwd_fused(FlatBwdP<TO> A, Geo G) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int W = blockDim.x >> 5, R = 16 * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, own0 = blockIdx.x * R;
  const unsigned rank = cluster_rank(), blocks = gridDim.x;
  const int N = G.N, N16 = (N + 15) & ~15;
  const int so = R * LDB, st = TQ * LDB;
  constexpr int OTH = (PX + PG) * TQ * LDB;        // one query tile: q^, then g
  __nv_bfloat16* ownX = reinterpret_cast<__nv_bfloat16*>(smem);   // k^, every term
  __nv_bfloat16* ownY = ownX + PX * so;            // v
  __nv_bfloat16* oth = ownY + PV * so;             // [2][OTH]
  __nv_bfloat16* dsT = oth + 2 * OTH;              // [hi, lo][R][LDS]: the tile's ds^T
  // [2][TQ / 16][4][32] float4: the block's dq^ of a tile, each thread's
  // fragment of a 16-row strip as four float4 (16 x 8 tiles) lane by lane
  float* part = reinterpret_cast<float*>(dsT + 2 * R * LDS);
  float* oth_lr = part + 2 * TQ * HD;              // [2][TQ]
  float* oth_tt = oth_lr + 2 * TQ;                 // [2][TQ]
  unsigned char* flags = reinterpret_cast<unsigned char*>(oth_tt + 2 * TQ);

  const bool split = !G.round_ops, p_split = !G.round_p;
  const bool synth = G.shift > 0;
  const int nx = split ? PX : 1, nyo = split ? PV : 1, nyt = split ? PG : 1;
  const float sc = A.scale[h];
  const size_t row0 = ((size_t)b * G.H + h) * N;
  const Staged& S = A.S;
  const __nv_bfloat16* qx = S.q + row0 * HD;
  const __nv_bfloat16* gy = S.g + row0 * HD;

  auto fetch_tile = [&](int t) {
    const int o0 = t * TQ, rows = min(TQ, N16 - o0);
    __nv_bfloat16* buf = oth + (t & 1) * OTH;
    copy_rows_async<PX>(qx, S.stride, nx, o0, rows, N, buf, st);
    copy_rows_async<PG>(gy, S.stride, nyt, o0, rows, N, buf + PX * st, st);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const bool in = o0 + i < N;
      const size_t at_i = row0 + (in ? o0 + i : 0);
      cp_async4(oth_lr + (t & 1) * TQ + i, A.lr + at_i, in);
      cp_async4(oth_tt + (t & 1) * TQ + i, A.tt + at_i, in);
    }
  };

  // every term of the own k^: the epilogue rebuilds k^ from them
  copy_rows_async<PX>(S.k + row0 * HD, S.stride, PX, own0, R, N, ownX, so);
  copy_rows_async<PV>(S.v + row0 * HD, S.stride, nyo, own0, R, N, ownY, so);
  fetch_tile(0);
  cp_async_commit();
  stage_flags(G, synth, N16, flags);

  const Logits LG{A.bias + (size_t)h * N * N, nullptr, flags, sc, N,
                  window_bands(G, synth, b)};
  const int keys = min(W, (N16 - own0) / 16);    // strips of keys below N16
  const bool active = warp < keys;                // else a strip of padding
  const int ra = own0 + 16 * warp + g8, rb = ra + 8;
  uint32_t ax[PX][2][4], ay[PV][2][4];
  int fa = 0, fb = 0;
  float add_next[2][4];
  if (active) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) LG.addends<true>(ra, rb, 8 * nt + 2 * t4, add_next[nt]);
  }
  float dv[4][4], dk[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[a][e] = dk[a][e] = 0.f;

  // The owner of query tile t: block t % blocks, a warp a 16-row strip.
  auto owns = [&](int t) {
    return (unsigned)t % blocks == rank && 16 * warp < min(TQ, N16 - t * TQ);
  };
  // q^ (its terms summed) at an owner thread's fragment of tile t: rows
  // 16 warp + g and + 8, columns 8 nt + 2 t4 and + 1; read before the
  // cluster's barrier, so that its latency hides behind the wait
  auto own_q = [&](int t, float2 (&xv)[2][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        xv[r][nt] = staged_pair<PX, HD>(qx + (size_t)t * TQ * HD, S.stride,
                                        16 * warp + g8 + 8 * r, 8 * nt + 2 * t4);
  };
  // dq of query tile t, on its owner: the cluster's shares added in block
  // order (two blocks' shares in flight at a time), then DQ's epilogue
  // (store_normalised's rsqrt-norm backward, and rowq) with own_q's q^
  auto finish_dq = [&](int t, const float2 (&xv)[2][4]) {
    if (!owns(t)) return;
    const float* mine = part + (t & 1) * TQ * HD + (4 * warp * 32 + lane) * 4;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    unsigned r = 0;
    for (; r + 1 < blocks; r += 2) {
      float4 v[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[q][j] = load_cluster(mine + j * 128, r + q);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] += v[q][j].x; acc[j][1] += v[q][j].y;
          acc[j][2] += v[q][j].z; acc[j][3] += v[q][j].w;
        }
    }
    for (; r < blocks; ++r) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = load_cluster(mine + j * 128, r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] += v[j].x; acc[j][1] += v[j].y;
        acc[j][2] += v[j].z; acc[j][3] += v[j].w;
      }
    }
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int i = t * TQ + 16 * warp + g8 + 8 * r2;
      float dot = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        dot += xv[r2][nt].x * (acc[nt][2 * r2] * sc) +
               xv[r2][nt].y * (acc[nt][2 * r2 + 1] * sc);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (i >= N) continue;
      const float n = S.qn[row0 + i];
      TO* out = A.dq + at(G.in, b, h, i);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store2(out + 8 * nt + 2 * t4, (acc[nt][2 * r2] * sc - xv[r2][nt].x * dot) * n,
               (acc[nt][2 * r2 + 1] * sc - xv[r2][nt].y * dot) * n);
      if (t4 == 0) A.rowq[row0 + i] = dot / sc;
    }
  };

  const int ntiles = (N16 + TQ - 1) / TQ;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) fetch_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile t (and the own rows) have landed
    __syncthreads();
    if (t == 0 && active) {
#pragma unroll
      for (int p = 0; p < PX; ++p) load_a(ax[p], ownX + p * so, 16 * warp);
#pragma unroll
      for (int p = 0; p < PV; ++p) load_a(ay[p], ownY + p * so, 16 * warp);
      fa = flags[ra];
      fb = flags[rb];
    }
    const int o0 = t * TQ, rows = min(TQ, N16 - o0);
    const __nv_bfloat16* othX = oth + (t & 1) * OTH;
    const __nv_bfloat16* othY = othX + PX * st;
    const float* tlr = oth_lr + (t & 1) * TQ;
    const float* ttt = oth_tt + (t & 1) * TQ;

    for (int sub = 0; active && sub < rows; sub += 16) {
      float s[2][4], dp[2][4], x[2][4], add[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) add[nt][e] = add_next[nt][e];
        // the next 16 columns' addends, in flight during this block's MMAs
        LG.addends<true>(ra, rb, o0 + sub + 16 + 8 * nt + 2 * t4, add_next[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        mma_terms_nk<PX, PX>(s[nt], ax, othX, st, sub + 8 * nt, split);
        mma_terms_nk<PV, PG>(dp[nt], ay, othY, st, sub + 8 * nt, split);
      }
      const bool edge = o0 + sub + 16 > N;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        LG.logits(o0 + sub + 8 * nt + 2 * t4, fa, fb, s[nt], add[nt], x[nt], edge);

      float p[2][4], ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = sub + 8 * nt + 2 * t4;
        const float2 lc = *reinterpret_cast<const float2*>(tlr + c);
        const float2 tc = *reinterpret_cast<const float2*>(ttt + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[nt][e] = LG.p(x[nt][e], (e & 1) ? lc.y : lc.x);
          ds[nt][e] = p[nt][e] * (dp[nt][e] - ((e & 1) ? tc.y : tc.x));
        }
        // keys past N add nothing to dq
        if (ra >= N) ds[nt][0] = ds[nt][1] = 0.f;
        if (rb >= N) ds[nt][2] = ds[nt][3] = 0.f;
      }
      uint32_t hi[4], lo[4];
      acc_to_a(p, hi, lo);
      mma_terms_kn<PG>(dv, hi, lo, othY, st, sub, p_split, split);
      acc_to_a(ds, hi, lo);
      mma_terms_kn<2>(dk, hi, lo, othX, st, sub, split, split);
      // ds^T's terms for the tile's dq product: (key g, queries 2t..), (key
      // g + 8, ..), (key g, queries 8 + 2t..), (key g + 8, ..)
      __nv_bfloat16* d = dsT + (16 * warp + g8) * LDS + sub + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = (e & 1) * 8 * LDS + (e >> 1) * 8;
        *reinterpret_cast<uint32_t*>(d + off) = hi[e];
        if (split) *reinterpret_cast<uint32_t*>(d + R * LDS + off) = lo[e];
      }
    }

    if (t > 0) {
      float2 xv[2][4];
      if (owns(t - 1)) own_q(t - 1, xv);
      cluster_wait();                 // every block's share of tile t - 1 is written
      finish_dq(t - 1, xv);
    }
    __syncthreads();                  // the tile's ds^T is complete
    // the block's share of dq^ for tile t: units of 16 queries x 16
    // columns, each a sum over the block's keys in order (hi.k0, then lo.k0
    // + hi.k1 on a second chain, as DQ's terms)
    float4* share = reinterpret_cast<float4*>(part + (t & 1) * TQ * HD);
    for (int u = warp; u < rows / 8; u += W) {
      const int sq = u >> 1, dh = u & 1;
      float c[2][4], c2[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = c2[n][e] = 0.f;
      for (int kk = 0; kk < keys; ++kk) {
        uint32_t hi[4], lo[4], bk[4];
        // A fragments of ds (queries x keys) from the ds^T rows
        const __nv_bfloat16* a = dsT + (16 * kk + (lane & 7) + (lane >> 4) * 8) * LDS +
                                 16 * sq + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(hi, a);
        load_b_kn(bk, ownX, 16 * kk, 16 * dh);
        mma16816(c[0], hi, bk[0], bk[1]);
        mma16816(c[1], hi, bk[2], bk[3]);
        if (split) {
          ldsm_x4_t(lo, a + R * LDS);
          mma16816(c2[0], lo, bk[0], bk[1]);
          mma16816(c2[1], lo, bk[2], bk[3]);
          load_b_kn(bk, ownX + so, 16 * kk, 16 * dh);
          mma16816(c2[0], hi, bk[0], bk[1]);
          mma16816(c2[1], hi, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
        share[(4 * sq + 2 * dh + n) * 32 + lane] =
            make_float4(c[n][0] + c2[n][0], c[n][1] + c2[n][1], c[n][2] + c2[n][2],
                        c[n][3] + c2[n][3]);
    }
    cluster_arrive();                 // this block's share of tile t is written
    __syncthreads();                  // tile t and the ds^T tile are consumed
  }
  {
    float2 xv[2][4];
    if (owns(ntiles - 1)) own_q(ntiles - 1, xv);
    cluster_wait();
    finish_dq(ntiles - 1, xv);
  }
  cluster_arrive();                   // no block leaves while its shares may be read
  cluster_wait();
  if (!active) return;

  float dots[2];
  store_normalised<TO>(dk, sc, ownX, so, 16 * warp + g8,
                       ra < N ? S.kn[row0 + ra] : 0.f, rb < N ? S.kn[row0 + rb] : 0.f,
                       ra < N ? A.dk + at(G.in, b, h, ra) : nullptr,
                       rb < N ? A.dk + at(G.in, b, h, rb) : nullptr, dots);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = r == 0 ? ra : rb;
    if (j >= N) continue;
    TO* out = A.dv + at(G.in, b, h, j);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      store2(out + 8 * nt + 2 * t4, dv[nt][2 * r], dv[nt][2 * r + 1]);
  }
}

// dbias and dscale: the block owns query rows 16 W * blockIdx.y.. and key
// columns TJ * blockIdx.x.. of head blockIdx.z / nchunk and adds ds over
// the windows of chunk blockIdx.z % nchunk (`per` windows each) in window
// order, in accumulator fragments; the windows' tiles arrive double
// buffered, the tile's bias sits in registers. It writes its tile to
// dst[chunk][h] ([nchunk, H, N, N]; dbias itself when nchunk is 1) and its
// share of dscale[h] = sum ds * s_cos (with ROWQ: the sum of its rows'
// q^ . dq^ / scale from A.rowq, in the first column tile) to
// part[((chunk * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * H + h];
// `sum_partials` adds the chunks and the blocks of a head in a fixed order.
template <int PV, int PG, typename TO, bool ROWQ, typename P>
__global__ void __launch_bounds__(32 * MAXW, 1) attn_bwd_sums(
    P A, float* __restrict__ dst, float* __restrict__ part, int Bn, int per,
    int nchunk, Geo G) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int W = blockDim.x >> 5, R = 16 * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.z / nchunk, chunk = blockIdx.z % nchunk;
  const int own0 = blockIdx.y * R, j0 = blockIdx.x * TJ;
  const int N = G.N, N16 = (N + 15) & ~15;
  const int rows = min(TJ, N16 - j0);
  const int so = R * LDB, st = TJ * LDB;
  const int stage = (PX + PG) * so + (PX + PV) * st;       // one window's tiles
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][stage]
  float* red = reinterpret_cast<float*>(tiles + 2 * stage);
  unsigned char* flags = reinterpret_cast<unsigned char*>(red + MAXW);

  const bool split = !G.round_ops;
  const bool synth = A.mask == nullptr && G.shift > 0;
  const int nx = split ? PX : 1, nv = split ? PV : 1, ng = split ? PG : 1;
  const float sc = A.scale[h];
  const bool active = own0 + 16 * warp < N;
  const int ra = own0 + 16 * warp + g8, rb = ra + 8;
  const Staged& S = A.S;

  auto fetch_window = [&](int b, int slot) {
    const size_t row0 = ((size_t)b * G.H + h) * N * HD;
    __nv_bfloat16* buf = tiles + slot * stage;
    copy_rows_async<PX>(S.q + row0, S.stride, nx, own0, R, N, buf, so);
    copy_rows_async<PG>(S.g + row0, S.stride, ng, own0, R, N, buf + PX * so, so);
    buf += (PX + PG) * so;
    copy_rows_async<PX>(S.k + row0, S.stride, nx, j0, rows, N, buf, st);
    copy_rows_async<PV>(S.v + row0, S.stride, nv, j0, rows, N, buf + PX * st, st);
  };

  const int b0 = chunk * per, b_end = min(Bn, b0 + per);
  fetch_window(b0, 0);
  cp_async_commit();
  stage_flags(G, synth, N16, flags);

  Logits LG{A.bias + (size_t)h * N * N, nullptr, flags, sc, N, 0};
  float acc[TJ / 16][2][4], bias_r[TJ / 16][2][4];
#pragma unroll
  for (int a = 0; a < TJ / 16; ++a)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][nt][e] = bias_r[a][nt][e] = 0.f;
      if (active)
        LG.fetch<false>(LG.bias, ra, rb, j0 + 16 * a + 8 * nt + 2 * t4, bias_r[a][nt]);
    }
  float dsc = 0.f;

  for (int b = b0; b < b_end; ++b) {
    const int slot = (b - b0) & 1;
    if (b + 1 < b_end) fetch_window(b + 1, slot ^ 1);
    cp_async_commit();
    // this window's row statistics and mask operand, in flight while its
    // tiles land
    const size_t stat0 = ((size_t)b * G.H + h) * N;
    float lr[2] = {-CUDART_INF_F, -CUDART_INF_F}, tt[2] = {0.f, 0.f};   // p = 0 past N
    float mask_r[TJ / 16][2][4];
    LG.wm = window_bands(G, synth, b);
    if (active) {
      if (ra < N) { lr[0] = A.lr[stat0 + ra]; tt[0] = A.tt[stat0 + ra]; }
      if (rb < N) { lr[1] = A.lr[stat0 + rb]; tt[1] = A.tt[stat0 + rb]; }
      if constexpr (ROWQ) {
        if (blockIdx.x == 0 && t4 == 0 && ra < N) dsc += A.rowq[stat0 + ra];
        if (blockIdx.x == 0 && t4 == 0 && rb < N) dsc += A.rowq[stat0 + rb];
      }
      if (A.mask != nullptr) {
        const float* mw = A.mask + (size_t)(b % G.nWmask) * N * N;
#pragma unroll
        for (int a = 0; a < TJ / 16; ++a)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            LG.fetch<false>(mw, ra, rb, j0 + 16 * a + 8 * nt + 2 * t4, mask_r[a][nt]);
      }
    }
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const __nv_bfloat16* ownX = tiles + slot * stage;
      const __nv_bfloat16* ownY = ownX + PX * so;
      const __nv_bfloat16* othX = ownY + PG * so;
      const __nv_bfloat16* othY = othX + PX * st;
      uint32_t ax[PX][2][4], ay[PG][2][4];
#pragma unroll
      for (int p = 0; p < PX; ++p) load_a(ax[p], ownX + p * so, 16 * warp);
#pragma unroll
      for (int p = 0; p < PG; ++p) load_a(ay[p], ownY + p * so, 16 * warp);
      const int fa = flags[ra], fb = flags[rb];

#pragma unroll
      for (int a = 0; a < TJ / 16; ++a) {
        if (16 * a < rows) {
          float s[2][4], dp[2][4], x[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
            mma_terms_nk<PX, PX>(s[nt], ax, othX, st, 16 * a + 8 * nt, split);
            mma_terms_nk<PG, PV>(dp[nt], ay, othY, st, 16 * a + 8 * nt, split);
          }
          const bool edge = j0 + 16 * a + 16 > N;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float add[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              add[e] = A.mask != nullptr ? bias_r[a][nt][e] + mask_r[a][nt][e]
                                         : bias_r[a][nt][e];
            LG.logits(j0 + 16 * a + 8 * nt + 2 * t4, fa, fb, s[nt], add, x[nt], edge);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ds = LG.p(x[nt][e], lr[e >> 1]) * (dp[nt][e] - tt[e >> 1]);
              acc[a][nt][e] += ds;
              if constexpr (!ROWQ) dsc += ds * s[nt][e];
            }
          }
        }
      }
    }
    __syncthreads();                  // this window's tiles are consumed
  }

  if (active) {
    float* tile = dst + ((size_t)chunk * G.H + h) * N * N;
#pragma unroll
    for (int a = 0; a < TJ / 16; ++a)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e >> 1) ? rb : ra;
          const int j = j0 + 16 * a + 8 * nt + 2 * t4 + (e & 1);
          if (i < N && j < N) tile[(size_t)i * N + j] = acc[a][nt][e];
        }
  }
  dsc = warp_sum(active ? dsc : 0.f);
  if (lane == 0) red[warp] = dsc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int w = 0; w < W; ++w) tot += red[w];
    part[(((size_t)chunk * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * G.H +
         h] = tot;
  }
}

template <typename F>
cudaError_t allow_smem(F fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct BwdArgs {
  const void *q, *k, *v, *bias, *scale, *mask, *g;
  void *dq, *dk, *dv, *dbias, *dscale, *lr, *tt, *part_db, *part_ds, *ops, *norms;
  const void *o, *r, *shiftm;   // FORWARD_ROWS: the forward's output, r; ROWSUMS: m
  void* rowq;                   // FORWARD_ROWS: K2's dscale terms
};

// Warps per block and blocks per window side: the ceil(N / 16) strips of 16
// rows spread evenly over the fewest blocks of at most MAXW warps (N = 784:
// 7 blocks of 7 warps, nothing ragged).
struct Plan {
  int W, tiles;
};
Plan plan_rows(int N) {
  const int strips = (N + 15) / 16, tiles = (strips + MAXW - 1) / MAXW;
  return Plan{(strips + tiles - 1) / tiles, tiles};
}

// K2 forms dq, dk and dv in its fused key-outer pass where a window side's
// blocks fit in one cluster (N <= 1024), else in its dq and dk/dv passes.
bool flat_bwd_fused(int N) { return plan_rows(N).tiles <= MAXC; }

struct FwdArgs {
  const void *q, *k, *v, *bias, *scale, *mask, *shiftm;
  void *out, *lr, *r, *ops;
};

// K1 (FLAT: the fixed-shift softmax in one pass) or K7/K8 (the row pass,
// then the output pass), after prep_forward.
template <typename T, typename TO, bool FLAT>
int launch_fwd(const FwdArgs& A, int Bn, const Geo& G, cudaStream_t stream) {
  constexpr int PV = Terms<T>::n;
  const int N16 = (G.N + 15) & ~15;
  const Plan P = plan_rows(G.N);
  auto smem = [&](int py, int r) {
    return (size_t)(PX * r + 2 * (PX + py) * TK) * LDB * 2 + N16;
  };
  cudaError_t err;
  if constexpr (FLAT) {
    err = allow_smem(attn_fwd_flat<PV, TO>, smem(PV, 16 * MAXW));
  } else {
    err = allow_smem(attn_fwd_stats<TO>, smem(0, 16 * MAXW));
    if (err == cudaSuccess) err = allow_smem(attn_fwd_out<PV, TO>, smem(PV, 16 * MAXW));
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t rows_total = (size_t)Bn * G.H * G.N, stride = rows_total * HD;
  __nv_bfloat16* ops = static_cast<__nv_bfloat16*>(A.ops);
  const Staged S{ops, ops + PX * stride, ops + 2 * PX * stride, nullptr, stride,
                 nullptr, nullptr};
  prep_forward<T><<<(unsigned)((4 * rows_total + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(A.q), static_cast<const T*>(A.k),
      static_cast<const T*>(A.v), S, Bn, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const FwdP<TO> F{S, static_cast<const float*>(A.bias),
                   static_cast<const float*>(A.scale), static_cast<const float*>(A.mask),
                   static_cast<const float*>(A.shiftm), static_cast<float*>(A.lr),
                   static_cast<float*>(A.r), static_cast<TO*>(A.out)};
  const dim3 grid(P.tiles, G.H, Bn);
  const int threads = 32 * P.W, R = 16 * P.W;
  if constexpr (FLAT) {
    attn_fwd_flat<PV, TO><<<grid, threads, smem(PV, R), stream>>>(F, G);
  } else {
    attn_fwd_stats<TO><<<grid, threads, smem(0, R), stream>>>(F, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_fwd_out<PV, TO><<<grid, threads, smem(PV, R), stream>>>(F, G);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward whose row terms come from ROWS (EXACT_ROWS, FORWARD_ROWS or
// FIXED_ROWS): prep_operands, the row pass if any, dq, dk/dv, dbias and
// dscale, and the fixed-order sums of their partials.
template <typename T, typename TO, int ROWS>
int launch_bwd(const BwdArgs& A, int Bn, int nchunk, const Geo& G,
               cudaStream_t stream) {
  constexpr int PV = Terms<T>::n, PG = Terms<TO>::n;
  constexpr int ROW_PASS = ROWS == EXACT_ROWS ? ROWSTATS : ROWSUMS;
  constexpr bool ROWQ = ROWS == FORWARD_ROWS;
  using Par = std::conditional_t<ROWS == EXACT_ROWS, BwdP<TO>, FlatBwdP<TO>>;
  const int N16 = (G.N + 15) & ~15;
  const Plan P = plan_rows(G.N);
  const int R = 16 * P.W, nJt = (N16 + TJ - 1) / TJ;
  auto rows_smem = [&](int pyo, int pyt, int r) {
    return (size_t)((PX + pyo) * r + 2 * (PX + pyt) * TK) * LDB * 2 +
           (size_t)4 * TK * 4 + N16;
  };
  auto sums_smem = [&](int r) {
    return (size_t)2 * ((PX + PG) * r + (PX + PV) * TJ) * LDB * 2 + MAXW * 4 + N16;
  };
  const bool fused = ROWS == FORWARD_ROWS && flat_bwd_fused(G.N);
  auto fused_smem = [&](int r) {
    return (size_t)((PX + PV) * r * LDB + 2 * (PX + PG) * TQ * LDB + 2 * r * LDS) * 2 +
           (size_t)2 * TQ * HD * 4 + (size_t)4 * TQ * 4 + N16;
  };
  cudaError_t err = cudaSuccess;
  if constexpr (ROWS != FORWARD_ROWS)
    err = allow_smem(attn_bwd_rows<PV, PG, TO, ROW_PASS, false, Par>,
                     rows_smem(PG, PV, 16 * MAXW));
  else
    err = allow_smem(attn_bwd_fused<PV, PG, TO>, fused_smem(16 * MAXW));
  if (err != cudaSuccess ||
      (err = allow_smem(attn_bwd_rows<PV, PG, TO, DQ, ROWQ, Par>,
                        rows_smem(PG, PV, 16 * MAXW))) != cudaSuccess ||
      (err = allow_smem(attn_bwd_rows<PV, PG, TO, DKV, false, Par>,
                        rows_smem(PV, PG, 16 * MAXW))) != cudaSuccess ||
      (err = allow_smem(attn_bwd_sums<PV, PG, TO, ROWQ, Par>, sums_smem(16 * MAXW))) !=
          cudaSuccess)
    return static_cast<int>(err);

  const size_t rows_total = (size_t)Bn * G.H * G.N, stride = rows_total * HD;
  __nv_bfloat16* ops = static_cast<__nv_bfloat16*>(A.ops);
  float* norms = static_cast<float*>(A.norms);
  const Staged S{ops, ops + PX * stride, ops + 2 * PX * stride,
                 ops + (2 * PX + PV) * stride, stride, norms, norms + rows_total};
  const FwdRows<TO> F{static_cast<const TO*>(A.o), static_cast<const float*>(A.r),
                      static_cast<const float*>(A.shiftm)};
  prep_operands<T, TO><<<(unsigned)((4 * rows_total + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(A.q), static_cast<const T*>(A.k),
      static_cast<const T*>(A.v), static_cast<const TO*>(A.g), S, Bn, G, F,
      static_cast<float*>(A.lr), static_cast<float*>(A.tt));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const BwdP<TO> base{S, static_cast<const float*>(A.bias),
                      static_cast<const float*>(A.scale),
                      static_cast<const float*>(A.mask), static_cast<float*>(A.lr),
                      static_cast<float*>(A.tt), static_cast<TO*>(A.dq),
                      static_cast<TO*>(A.dk), static_cast<TO*>(A.dv)};
  Par B;
  if constexpr (ROWS == EXACT_ROWS)
    B = base;
  else
    B = Par{base, static_cast<const float*>(A.shiftm), static_cast<float*>(A.rowq)};
  const dim3 grid(P.tiles, G.H, Bn);
  const int threads = 32 * P.W;
  if constexpr (ROWS != FORWARD_ROWS) {
    attn_bwd_rows<PV, PG, TO, ROW_PASS, false, Par>
        <<<grid, threads, rows_smem(PG, PV, R), stream>>>(B, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (fused) {
    if constexpr (ROWS == FORWARD_ROWS) {
      // one cluster per window and head: its blocks add their dq shares
      // through each other's shared memory
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = P.tiles;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = grid;
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = fused_smem(R);
      cfg.stream = stream;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if ((err = cudaLaunchKernelEx(&cfg, attn_bwd_fused<PV, PG, TO>, B, G)) != cudaSuccess)
        return static_cast<int>(err);
    }
  } else {
    attn_bwd_rows<PV, PG, TO, DQ, ROWQ, Par>
        <<<grid, threads, rows_smem(PG, PV, R), stream>>>(B, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attn_bwd_rows<PV, PG, TO, DKV, false, Par>
        <<<grid, threads, rows_smem(PV, PG, R), stream>>>(B, G);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  float* dbias = static_cast<float*>(A.dbias);
  float* part_db = static_cast<float*>(A.part_db);
  float* part_ds = static_cast<float*>(A.part_ds);
  const int per = (Bn + nchunk - 1) / nchunk;
  attn_bwd_sums<PV, PG, TO, ROWQ, Par>
      <<<dim3(nJt, P.tiles, G.H * nchunk), threads, sums_smem(R), stream>>>(
          B, nchunk > 1 ? part_db : dbias, part_ds, Bn, per, nchunk, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (nchunk > 1) {
    const size_t L = (size_t)G.H * G.N * G.N;
    sum_partials<<<(unsigned)((L + 255) / 256), 256, 0, stream>>>(part_db, dbias,
                                                                  nchunk, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  sum_partials<<<(G.H + 127) / 128, 128, 0, stream>>>(
      part_ds, static_cast<float*>(A.dscale), nchunk * P.tiles * nJt, (size_t)G.H);
  return static_cast<int>(cudaGetLastError());
}

// geo: N, H, ws, shift, nWh, nWw, nWmask, round_ops, round_p, layout (0
// head, 1 map, 2 flat), Hp, Wp
Geo make_geo(const int* geo) {
  Geo G{};
  G.N = geo[0]; G.H = geo[1]; G.ws = geo[2]; G.shift = geo[3];
  G.nWh = geo[4]; G.nWw = geo[5]; G.nWmask = geo[6];
  G.round_ops = geo[7]; G.round_p = geo[8];
  const int layout = geo[9], Hp = geo[10], Wp = geo[11];
  const long long hd = 32, C = G.H * hd;
  if (layout == 1) {
    G.in = Lay{1, G.ws, G.nWw, G.nWh * G.nWw, Hp, Wp, 3 * C, hd, 0};
    G.out = Lay{1, G.ws, G.nWw, G.nWh * G.nWw, Hp, Wp, C, hd, 0};
  } else if (layout == 2) {     // qkv [Bn, N, 3C]; o, g [Bn, N, C]
    G.in = Lay{0, 0, 0, 0, 0, 0, 3 * C, hd, G.N * 3 * C};
    G.out = Lay{0, 0, 0, 0, 0, 0, C, hd, G.N * C};
  } else {
    G.in = Lay{0, 0, 0, 0, 0, 0, hd, G.N * hd, G.H * G.N * hd};
    G.out = G.in;
  }
  return G;
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return (any & 15) != 0;
}

}  // namespace

// K8 (layout 0: q, k, v, out [Bn, H, N, 32]) and K7 (layout 1: q, k, v point
// at the three parts of qkv [B, Hp, Wp, 3, H, 32], out [B, Hp, Wp, H, 32],
// Bn = B * nWh * nWw). `geo` holds the twelve integers of `make_geo`; every
// row of q, k, v is 16-byte aligned. Scratch: lr [Bn, H, N] fp32; ops (6 +
// terms of v) * Bn * H * N * 32 bf16, terms 1 for a bf16 and 2 for an fp32
// tensor.
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* scale,
                                    const void* mask, void* out, void* lr,
                                    void* ops, int in_bf16, int out_bf16, int Bn,
                                    const int* geo, void* stream) {
  const Geo G = make_geo(geo);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs A{q, k, v, bias, scale, mask, nullptr, out, lr, nullptr, ops};
  if (misaligned({q, k, v, ops})) return static_cast<int>(cudaErrorInvalidValue);
  if (in_bf16 && out_bf16)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16, false>(A, Bn, G, s);
  if (in_bf16) return launch_fwd<__nv_bfloat16, float, false>(A, Bn, G, s);
  if (!out_bf16) return launch_fwd<float, float, false>(A, Bn, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1, flat layout: qkv [Bn, N, 3C] bf16 or fp32 (16-byte aligned), out [Bn,
// N, C] in its type, shiftm [H] the fixed shifts m_h, r [Bn, H, N] fp32 (or
// null: not written); geo with layout 2. Scratch: ops as
// window_attention_fwd's.
extern "C" int window_attention_flat_fwd(const void* qkv, const void* bias,
                                         const void* scale, const void* shiftm,
                                         void* out, void* r, void* ops, int is_bf16,
                                         int Bn, const int* geo, void* stream) {
  const Geo G = make_geo(geo);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t step = (size_t)G.H * HD * (is_bf16 ? 2 : 4);   // C values
  const char* in = static_cast<const char*>(qkv);
  const FwdArgs A{in,     in + step, in + 2 * step, bias, scale, nullptr,
                  shiftm, out,       nullptr,       r,    ops};
  if (geo[9] != 2 || misaligned({qkv, ops})) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch_fwd<__nv_bfloat16, __nv_bfloat16, true>(A, Bn, G, s)
                 : launch_fwd<float, float, true>(A, Bn, G, s);
}

// K8b and K7b. g has out's layout and type; dq, dk, dv have q's layout and
// out's type; every row of q, k, v, g is 16-byte aligned. The windows are
// summed into dbias in `nchunk` chunks of ceil(Bn / nchunk). Scratch: lr,
// tt [Bn, H, N] fp32; part_db [nchunk, H, N, N] fp32 when nchunk > 1;
// part_ds nchunk * tiles * ceil(N16 / 64) * H fp32, tiles the row blocks of
// `plan_rows`; ops (6 + terms of v + terms of g) * Bn * H * N * 32 bf16,
// terms 1 for a bf16 and 2 for an fp32 tensor; norms 2 * Bn * H * N fp32.
extern "C" int window_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* scale, const void* mask, const void* g, void* dq, void* dk,
    void* dv, void* dbias, void* dscale, void* lr, void* tt, void* part_db,
    void* part_ds, void* ops, void* norms, int nchunk, int in_bf16, int out_bf16,
    int Bn, const int* geo, void* stream) {
  const Geo G = make_geo(geo);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs A{q,  k,  v,     bias,   scale, mask, g,       dq,      dk,
                  dv, dbias, dscale, lr, tt,   part_db, part_ds, ops, norms,
                  nullptr, nullptr, nullptr, nullptr};
  if (nchunk < 1 || nchunk > Bn || misaligned({q, k, v, g, ops}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_bf16 && out_bf16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16, EXACT_ROWS>(A, Bn, nchunk, G, s);
  if (in_bf16) return launch_bwd<__nv_bfloat16, float, EXACT_ROWS>(A, Bn, nchunk, G, s);
  if (!out_bf16) return launch_bwd<float, float, EXACT_ROWS>(A, Bn, nchunk, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2 (o, r: the forward's output [Bn, N, C] and reciprocal row sums [Bn, H,
// N]) and K5 (o and r null: the fixed-shift row pass first), flat layout:
// qkv [Bn, N, 3C], g like o, dqkv like qkv, all of one type; shiftm [H] the
// fixed shifts m_h; geo with layout 2. Scratch as window_attention_bwd's,
// with one term of v and g for bf16 and two for fp32, and for K2 rowq [Bn,
// H, N] fp32: its dscale is sum q^ . dq^ / scale, as the Pallas K2 forms it
// (K5's, sum ds * s_cos, is the Pallas K5's).
extern "C" int window_attention_flat_bwd(
    const void* qkv, const void* bias, const void* scale, const void* shiftm,
    const void* o, const void* r, const void* g, void* dqkv, void* dbias,
    void* dscale, void* lr, void* tt, void* rowq, void* part_db, void* part_ds,
    void* ops, void* norms, int nchunk, int is_bf16, int Bn, const int* geo,
    void* stream) {
  const Geo G = make_geo(geo);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t step = (size_t)G.H * HD * (is_bf16 ? 2 : 4);   // C values
  const char* in = static_cast<const char*>(qkv);
  char* d = static_cast<char*>(dqkv);
  const BwdArgs A{in,      in + step, in + 2 * step, bias,  scale, nullptr, g,
                  d,       d + step,  d + 2 * step,  dbias, dscale, lr,     tt,
                  part_db, part_ds,   ops,           norms, o,      r,      shiftm,
                  o != nullptr ? rowq : nullptr};
  // C values are 64 H bytes: k and v are aligned when qkv is
  if (nchunk < 1 || nchunk > Bn || geo[9] != 2 || (o == nullptr) != (r == nullptr) ||
      (o != nullptr && rowq == nullptr) || misaligned({qkv, g, o, ops}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (o != nullptr)
    return is_bf16
               ? launch_bwd<__nv_bfloat16, __nv_bfloat16, FORWARD_ROWS>(A, Bn, nchunk, G, s)
               : launch_bwd<float, float, FORWARD_ROWS>(A, Bn, nchunk, G, s);
  return is_bf16
             ? launch_bwd<__nv_bfloat16, __nv_bfloat16, FIXED_ROWS>(A, Bn, nchunk, G, s)
             : launch_bwd<float, float, FIXED_ROWS>(A, Bn, nchunk, G, s);
}

// 1 where K2 (window_attention_flat_bwd with o and r) at window size N runs
// its fused pass, 0 where it runs the dq and dk/dv passes.
extern "C" int window_attention_flat_bwd_fused(int N) { return flat_bwd_fused(N); }
