// The tiled tensor-core GEMM core of the fused MLP + LayerNorm kernels
// (mlp_ln.cu): C[M][N] = sum over k of A[m][k] B[k][n], bf16 operands, fp32
// sums, a fused epilogue on the fp32 accumulators.
//
// Operands are bf16 "planes": an operand of bf16 values is one plane; an
// fp32 operand is two, hi = bf16(x) and lo = bf16(x - hi), the lo term taken
// from the fp32 value (`split_terms`, or an epilogue's `store_terms2`). With
// P = 2 planes the core adds three products per step, hi.hi + hi.lo +
// lo.hi (the lo.lo pair is below 2^-16 of the product and dropped), the
// split of attn_mma.cuh's backward passes: about 2^-17 of each product.
//
// Layouts (template parameters): A stored [M][K] (k contiguous) or, with
// AT, [K][M] (a transposed read, for the weight gradients' x^T and h^T);
// B stored [K][N] or, with BT, [N][K] (W^T read in place, for the
// backward's dzb.W2^T and dhb.W1^T).
//
// Design. A block computes a BM x BN = 128 x 128 tile of C with 8 warps,
// each a 64 x 32 sub-tile (4 x 4 `mma.sync.m16n8k16` tiles, 64 fp32
// accumulators a thread; WARPS_M x WARPS_N sets the split). The k
// dimension goes in steps of BK = 64 through a ring of three tiles in
// shared memory (108 KB for bf16, so two blocks share an SM; 216 KB with
// the second plane), filled by `cp.async` 16 bytes a thread two steps
// ahead of the tensor cores; fragments are read with `ldmatrix` (`.trans`
// where the stored layout is the transpose of the fragment's).
// Shared-memory rows are padded to an odd number of 16-byte groups (72 or
// 136 bf16), so no `ldmatrix` has a bank conflict. On an H100 (700 W),
// 64 x 32 warp tiles beat 64 x 64 ones with 4 warps a block by 5-20 %, and
// BK = 64 with three stages beat BK = 32 with four by about 6 %
// (`tools/kernel_ab.py` between the two sources). Rows and columns past
// the operand's end are zero-filled by the copy (`cp.async` with source
// size 0), so a ragged M, N or K needs no padding in device memory, and a
// row group of the k dimension (blockIdx.z, `k_split` rows) gives the
// weight gradients' split over M. The epilogue is a functor called once
// per accumulator pair (row, column, column + 1) of the rows and columns
// inside C; with `kColSums` it returns the pair to add into the tile's
// column sums, which the block reduces in a fixed order (shuffles over the
// 8 rows of a fragment, then the warp rows through shared memory) and
// writes as one partial per row tile: no atomics, so every launch gives
// the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {
namespace gemm {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int WARPS_M = 2, WARPS_N = 4;          // warps of a block
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;   // a warp's sub-tile
constexpr int MI = WTM / 16, NJ = WTN / 8;       // its m16n8 MMA tiles
constexpr int LDK = BK + 8;       // a k-contiguous tile row: 144 bytes
constexpr int LDMN = BM + 8;      // an m- or n-contiguous tile row: 272 bytes
// bf16 per plane of one operand tile, in either layout
constexpr int TILE = BM * LDK > BK * LDMN ? BM * LDK : BK * LDMN;
static_assert(BN == BM, "one tile size for both operands");

// The k-step ring of P-plane operands: its depth and its shared memory.
template <int P>
struct Ring {
  static constexpr int kStages = 3;
  static constexpr size_t kBytes =
      (size_t)kStages * 2 * P * TILE * sizeof(__nv_bfloat16);
};

// An operand in device memory: plane p of element (row, column) of its
// stored layout at p[p * plane + row * ld + column].
struct Operand {
  const __nv_bfloat16* p;
  size_t plane;
  int ld;
};

// fp32 x [n] → two bf16 planes, dst[i] = hi, dst[n + i] = lo.
__global__ void split_terms(const float* __restrict__ x,
                            __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float v = x[i];
    const __nv_bfloat16 hi = __float2bfloat16(v);
    dst[i] = hi;
    dst[n + i] = __float2bfloat16(v - __bfloat162float(hi));
  }
}

inline int split(const float* x, __nv_bfloat16* dst, size_t n,
                 cudaStream_t stream) {
  const size_t want = (n + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  split_terms<<<blocks, 256, 0, stream>>>(x, dst, n);
  return static_cast<int>(cudaGetLastError());
}

// R x COLS bf16 of a stored operand (rows r0.., columns c0..; valid below
// nr and nc, zero-filled past them) into a [R][LD] shared tile.
template <int R, int COLS, int LD>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int r0, int c0, int nr, int nc) {
  constexpr int CH = COLS / 8;
  static_assert(R * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < R * CH / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < nr && c0 + c < nc;
    cp_async16(dst + r * LD + c,
               ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

template <int P, bool AT, bool BT>
__device__ __forceinline__ void load_stage(__nv_bfloat16* sa, __nv_bfloat16* sb,
                                           const Operand& A, const Operand& B,
                                           int m0, int n0, int k0, int M, int N,
                                           int k_end) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat16* a = A.p + p * A.plane;
    const __nv_bfloat16* b = B.p + p * B.plane;
    if (AT)
      copy_tile<BK, BM, LDMN>(sa + p * TILE, a, A.ld, k0, m0, k_end, M);
    else
      copy_tile<BM, BK, LDK>(sa + p * TILE, a, A.ld, m0, k0, M, k_end);
    if (BT)
      copy_tile<BN, BK, LDK>(sb + p * TILE, b, B.ld, n0, k0, N, k_end);
    else
      copy_tile<BK, BN, LDMN>(sb + p * TILE, b, B.ld, k0, n0, k_end, N);
  }
}

// A fragment (PTX mma.m16n8k16 layout) of rows m..m+15, depth k..k+15.
template <bool AT>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int m, int k) {
  const int lane = threadIdx.x & 31;
  if (AT)
    ldsm_x4_t(a, s + (k + (lane & 7) + ((lane >> 4) & 1) * 8) * LDMN + m +
                     ((lane >> 3) & 1) * 8);
  else
    ldsm_x4(a, s + (m + (lane & 15)) * LDK + k + (lane >> 4) * 8);
}

// B fragments of columns n..n+15, depth k..k+15: (b[0], b[1]) columns
// n..n+7, (b[2], b[3]) columns n+8..n+15.
template <bool BT>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const __nv_bfloat16* s,
                                       int n, int k) {
  const int lane = threadIdx.x & 31;
  if (BT)
    ldsm_x4(b, s + (n + (lane & 7) + ((lane >> 4) & 1) * 8) * LDK + k +
                   ((lane >> 3) & 1) * 8);
  else
    ldsm_x4_t(b, s + (k + (lane & 7) + ((lane >> 3) & 1) * 8) * LDMN + n +
                     (lane >> 4) * 8);
}

// C tile (blockIdx.y, blockIdx.x) of A.B over the k rows of group
// blockIdx.z: [z * k_split, min(K, (z + 1) * k_split)), k_split a
// multiple of BK.
template <int P, bool AT, bool BT, class Epi>
__global__ void __launch_bounds__(THREADS, P == 1 ? 2 : 1)
    gemm_kernel(Operand A, Operand B, int M, int N, int K, int k_split, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int S = Ring<P>::kStages;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int kt_n = (k_end - k_begin + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
  auto tile_a = [&](int s) { return smem + (size_t)(2 * s) * P * TILE; };
  auto tile_b = [&](int s) { return smem + (size_t)(2 * s + 1) * P * TILE; };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < kt_n)
      load_stage<P, AT, BT>(tile_a(s), tile_b(s), A, B, m0, n0,
                            k_begin + s * BK, M, N, k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();   // step kt has landed; step kt - 1's tiles are free
    const int next = kt + S - 1;
    if (next < kt_n)
      load_stage<P, AT, BT>(tile_a(next % S), tile_b(next % S), A, B, m0, n0,
                            k_begin + next * BK, M, N, k_end);
    cp_async_commit();
    const __nv_bfloat16* ta = tile_a(kt % S);
    const __nv_bfloat16* tb = tile_b(kt % S);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[P][MI][4], b[P][NJ / 2][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < MI; ++i) frag_a<AT>(a[p][i], ta + p * TILE, wm + 16 * i, kk);
#pragma unroll
        for (int j = 0; j < NJ / 2; ++j) frag_b<BT>(b[p][j], tb + p * TILE, wn + 16 * j, kk);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int jb = j >> 1, e = (j & 1) * 2;
          mma16816(acc[i][j], a[0][i], b[0][jb][e], b[0][jb][e + 1]);
          if constexpr (P == 2) {
            mma16816(acc[i][j], a[0][i], b[P - 1][jb][e], b[P - 1][jb][e + 1]);
            mma16816(acc[i][j], a[P - 1][i], b[0][jb][e], b[0][jb][e + 1]);
          }
        }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  float cs[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = n0 + wn + 8 * j + 2 * t;
        if (c >= N) continue;
        const float2 s = epi(r, c, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        cs[j][0] += s.x;
        cs[j][1] += s.y;
      }
    }
  if constexpr (Epi::kColSums) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], off);
    __syncthreads();   // every warp is past its last tile read
    float* red = reinterpret_cast<float*>(smem_raw);    // [WARPS_M][BN]
    if (g == 0)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        red[(warp / WARPS_N) * BN + wn + 8 * j + 2 * t] = cs[j][0];
        red[(warp / WARPS_N) * BN + wn + 8 * j + 2 * t + 1] = cs[j][1];
      }
    __syncthreads();
    for (int c = threadIdx.x; c < BN && n0 + c < N; c += THREADS) {
      float total = red[c];
#pragma unroll
      for (int w = 1; w < WARPS_M; ++w) total += red[w * BN + c];
      epi.col_part[(size_t)blockIdx.y * N + n0 + c] = total;
    }
  }
}

// Launch C = A.B over K in row groups of k_split (a multiple of BK; K for
// one group) with the epilogue `epi`.
template <int P, bool AT, bool BT, class Epi>
int run(const Operand& A, const Operand& B, int M, int N, int K, int k_split,
        const Epi& epi, cudaStream_t stream) {
  constexpr size_t smem = Ring<P>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<P, AT, BT, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM,
                  (K + k_split - 1) / k_split);
  gemm_kernel<P, AT, BT, Epi><<<grid, THREADS, smem, stream>>>(A, B, M, N, K,
                                                             k_split, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
}  // namespace
