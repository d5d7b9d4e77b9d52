// Device helpers shared by the kernels of this directory: the warp sum,
// the exact-erf GELU and its derivative, and the fixed-order sum of
// per-block partials that keeps every column sum off atomics.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * expf(-0.5f * v * v);
}

// out[l] = sum over s of part[s][l], s in order
__global__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ out, int S, size_t L) {
  const size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float t = 0.f;
  for (int s = 0; s < S; ++s) t += part[(size_t)s * L + l];
  out[l] = t;
}

}  // namespace
