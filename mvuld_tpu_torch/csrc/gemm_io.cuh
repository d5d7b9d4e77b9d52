// Element I/O of the GEMM passes' epilogues and row passes (pairs and
// runs of four values in bf16 or fp32), and the two-level fixed-order sum
// of per-block partials: shared by mlp_ln.cu and fused_dense.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "common.cuh"

namespace {

constexpr int GROUP = 32;        // partials a thread adds at one level

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = low_f(u.x); v[1] = high_f(u.x); v[2] = low_f(u.y); v[3] = high_f(u.y);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// out[g][l] = sum over s in [g * GROUP, (g + 1) * GROUP) ∩ [0, S) of
// part[s][l], s in order: the first level of a fixed-order sum over many
// partials (one thread per column would add them all one after another)
__global__ void sum_groups(const float* __restrict__ part,
                           float* __restrict__ out, int S, size_t L) {
  const size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int s1 = min(S, (int)(blockIdx.y + 1) * GROUP);
  float t = 0.f;
  for (int s = blockIdx.y * GROUP; s < s1; ++s) t += part[(size_t)s * L + l];
  out[blockIdx.y * L + l] = t;
}

// out[l] = sum over s of part[s][l] in a fixed order; past GROUP partials
// in two levels through tmp ([ceil(S / GROUP)][L])
int sum_into(const float* part, float* out, int S, size_t L, float* tmp,
             cudaStream_t s) {
  const unsigned blocks = (unsigned)((L + 255) / 256);
  if (S > GROUP && tmp != nullptr) {
    const int groups = (S + GROUP - 1) / GROUP;
    sum_groups<<<dim3(blocks, groups), 256, 0, s>>>(part, tmp, S, L);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    part = tmp;
    S = groups;
  }
  sum_partials<<<blocks, 256, 0, s>>>(part, out, S, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
