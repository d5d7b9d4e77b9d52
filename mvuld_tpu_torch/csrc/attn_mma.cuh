// Tensor-core building blocks of the attention backward kernels: bf16
// `mma.sync.m16n8k16` products with fp32 accumulators, operands staged once
// per tile in shared memory as bf16 terms and read back with `ldmatrix`.
//
// Split operands. A product of fp32 operands is the sum of a few bf16
// products: x = x0 + x1 (+ x2), x0 = bf16(x), x1 = bf16(x - x0), ..., and
// a.b = sum of a_i.b_j over the term pairs with i + j <= order. Two terms
// and three products leave about 2^-17 of the product; three terms and six
// products are exact to fp32 and are what the logits take, whose error is
// multiplied by the logit scale (up to 100) before the exp. An operand that
// already is bf16 has one term.
//
// Shared-memory tiles are [rows][LDB] bf16 with LDB = 40: a head row (32
// values, 64 bytes) padded to 80 bytes, so the eight 16-byte rows of one
// `ldmatrix` 8 x 8 matrix fall into eight different 16-byte bank groups
// (80 / 16 = 5 is odd) and no fragment load has a bank conflict. A
// preparation kernel reads each operand row once through 16-byte loads,
// four threads a row, normalises it in fp32 where the product wants x^
// (`normalise8`) and writes its terms (`store_terms`); the product kernels
// then fill their tiles with `cp.async` (`copy_rows_async`), 16 bytes a
// thread, and can keep the next tile in flight behind the current one.
//
// Fragments (PTX ISA, mma.m16n8k16; g = lane / 4, t = lane % 4):
//   A 16 x 16: a0 (row g, k 2t..2t+1), a1 (row g+8), a2 (row g, k 8+2t..),
//              a3 (row g+8, k 8+2t..)
//   B 16 x 8:  b0 (k 2t..2t+1, n g), b1 (k 8+2t.., n g)
//   C 16 x 8:  c0, c1 (row g, n 2t, 2t+1), c2, c3 (row g+8)
// so the accumulators of two neighbouring 16 x 8 tiles, packed to bf16, are
// the A fragment of the next product (p and ds never pass through memory).
//
// The helpers know nothing of the softmax. A kernel brings its own "logit
// source": a struct that turns (row, column, q^.k^) into the logit and the
// row statistic into p. window_attention.cu's `Logits` serves the exact and
// the fixed-shift softmax (bias + mask operand or synthesised shift mask,
// p = 2^(x log2e + lr)), which differ in their row statistics only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 32;    // head dim
constexpr int LDB = 40;   // bf16 elements per shared-memory row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float low_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float high_f(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// (a, b) as bf16 pairs hi + lo
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack2(a, b);
  lo = pack2(a - low_f(hi), b - high_f(hi));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a . b, one 16 x 8 x 16 step
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of rows r0..r0+15 of a [*][LDB] tile, both depth steps
// (k 0..15 and 16..31).
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const __nv_bfloat16* tile,
                                       int r0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p =
      tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + (lane >> 4) * 8;
  ldsm_x4(a[0], p);
  ldsm_x4(a[1], p + 16);
}

// B fragments for c[m][n] += a[m][k] * tile[n0 + n][k], n 0..7, k 0..31:
// (b[0], b[1]) the first depth step, (b[2], b[3]) the second.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                          int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7)) * LDB + (lane >> 3) * 8);
}

// B fragments for c[m][n] += a[m][k] * tile[k0 + k][n0 + n], k 0..15,
// n 0..15: (b[0], b[1]) columns n0..n0+7, (b[2], b[3]) columns n0+8..n0+15.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + n0 +
                   (lane >> 4) * 8);
}

// c (16 x 8) += a (16 x 32) . b (8 x 32)^T for fragments of load_a / load_b_nk
__device__ __forceinline__ void mma_k32(float (&c)[4], const uint32_t (&a)[2][4],
                                        const uint32_t (&b)[4]) {
  mma16816(c, a[0], b[0], b[1]);
  mma16816(c, a[1], b[2], b[3]);
}

// c (16 x 8) += sum over the term pairs i + j <= order of a_i . b_j^T, the
// b terms read from the PB tiles `tile + j * stride` at rows n0..n0+7; only
// the first pair unless `split`. The a_0 pairs add into c and the others
// into a second accumulator, so two chains of dependent MMAs run at once.
template <int PA, int PB>
__device__ __forceinline__ void mma_terms_nk(float (&c)[4],
                                             const uint32_t (&a)[PA][2][4],
                                             const __nv_bfloat16* tile, int stride,
                                             int n0, bool split) {
  constexpr int order = (PA > PB ? PA : PB) - 1;
  uint32_t b[PB][4];
  load_b_nk(b[0], tile, n0);
  mma_k32(c, a[0], b[0]);
  if (split) {
#pragma unroll
    for (int j = 1; j < PB; ++j) load_b_nk(b[j], tile + j * stride, n0);
    float c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 1; j < PB; ++j)
      if (j <= order) mma_k32(c, a[0], b[j]);
#pragma unroll
    for (int i = 1; i < PA; ++i)
#pragma unroll
      for (int j = 0; j < PB; ++j)
        if (i + j <= order) mma_k32(c2, a[i], b[j]);
    if (PA > 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] += c2[e];
    }
  }
}

// acc (16 x 32, four 16 x 8 tiles) += sum over i + j <= 1 of a_i . b_j, a_i
// A fragments built from accumulators (hi, lo), b_j the PB tiles
// `tile + j * stride` read at rows k0..k0+15; only hi . b_0 unless the
// operand is split (`a_split` for a's lo term, `b_split` for b's).
template <int PB>
__device__ __forceinline__ void mma_terms_kn(float (&acc)[4][4],
                                             const uint32_t (&a_hi)[4],
                                             const uint32_t (&a_lo)[4],
                                             const __nv_bfloat16* tile, int stride,
                                             int k0, bool a_split, bool b_split) {
#pragma unroll
  for (int dh = 0; dh < 2; ++dh) {
    uint32_t b[4];
    load_b_kn(b, tile, k0, 16 * dh);
    mma16816(acc[2 * dh], a_hi, b[0], b[1]);
    mma16816(acc[2 * dh + 1], a_hi, b[2], b[3]);
    if (a_split) {
      mma16816(acc[2 * dh], a_lo, b[0], b[1]);
      mma16816(acc[2 * dh + 1], a_lo, b[2], b[3]);
    }
    if (PB > 1 && b_split) {
      load_b_kn(b, tile + stride, k0, 16 * dh);
      mma16816(acc[2 * dh], a_hi, b[0], b[1]);
      mma16816(acc[2 * dh + 1], a_hi, b[2], b[3]);
    }
  }
}

// The A fragment (hi, lo) of a 16 x 16 block held as the accumulators of
// two neighbouring 16 x 8 tiles.
__device__ __forceinline__ void acc_to_a(const float (&v)[2][4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split2(v[0][0], v[0][1], hi[0], lo[0]);
  split2(v[0][2], v[0][3], hi[1], lo[1]);
  split2(v[1][0], v[1][1], hi[2], lo[2]);
  split2(v[1][2], v[1][3], hi[3], lo[3]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  x[0] = low_f(u.x); x[1] = high_f(u.x); x[2] = low_f(u.y); x[3] = high_f(u.y);
  x[4] = low_f(u.z); x[5] = high_f(u.z); x[6] = low_f(u.w); x[7] = high_f(u.w);
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Eight values of a row as PARTS bf16 terms, 16 bytes each, written to
// dst + p * stride (device or shared memory).
template <int PARTS>
__device__ __forceinline__ void store_terms(float (&x)[8], __nv_bfloat16* dst,
                                            size_t stride) {
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
    uint4 u;
    u.x = pack2(x[0], x[1]); u.y = pack2(x[2], x[3]);
    u.z = pack2(x[4], x[5]); u.w = pack2(x[6], x[7]);
    *reinterpret_cast<uint4*>(dst + p * stride) = u;
    if (p + 1 < PARTS) {
      x[0] -= low_f(u.x); x[1] -= high_f(u.x); x[2] -= low_f(u.y);
      x[3] -= high_f(u.y); x[4] -= low_f(u.z); x[5] -= high_f(u.z);
      x[6] -= low_f(u.w); x[7] -= high_f(u.w);
    }
  }
}

// x *= rsqrt(sum x^2 + 1e-12) over the row's 32 values, held eight each by
// four neighbouring lanes (all four call it); returns the factor.
__device__ __forceinline__ float normalise8(float (&x)[8]) {
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) ss += x[e] * x[e];
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float n = rsqrtf(ss + 1e-12f);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] *= n;
  return n;
}

// Asynchronous copies into shared memory (`cp.async`); with !valid the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Rows r0..r0+R-1 of the first `terms` of PARTS term arrays (`src + p *
// src_stride`, rows of 32 bf16 back to back) into the tiles `dst + p *
// dst_stride` ([R][LDB]), asynchronously; rows at or past n_valid are zero.
// The caller commits.
template <int PARTS>
__device__ __forceinline__ void copy_rows_async(const __nv_bfloat16* src,
                                                size_t src_stride, int terms, int r0,
                                                int R, int n_valid,
                                                __nv_bfloat16* dst, int dst_stride) {
  for (int idx = threadIdx.x; idx < 4 * R; idx += blockDim.x) {
    const int r = idx >> 2, c = idx & 3;
    const bool in = r0 + r < n_valid;
    const __nv_bfloat16* from = src + (size_t)(in ? r0 + r : 0) * HD + 8 * c;
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      if (p < terms)
        cp_async16(dst + p * dst_stride + r * LDB + 8 * c, from + p * src_stride, in);
  }
}

// 2^x, flushing denormals (`ex2.approx.ftz`)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The fp32 value pair at (row, column d, d + 1) of an operand staged as
// PARTS term tiles `stride` apart, rows LD apart (a shared-memory tile; LD
// HD for the staged operands in device memory): the sum of its terms.
template <int PARTS, int LD = LDB, typename ST = int>
__device__ __forceinline__ float2 staged_pair(const __nv_bfloat16* tile, ST stride,
                                              int row, int d) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int p = PARTS - 1; p >= 0; --p) {
    const uint32_t u =
        *reinterpret_cast<const uint32_t*>(tile + p * stride + row * LD + d);
    v.x += low_f(u);
    v.y += high_f(u);
  }
  return v;
}

}  // namespace
