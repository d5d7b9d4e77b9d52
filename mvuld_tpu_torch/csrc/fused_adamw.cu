// Clip-by-global-norm and AdamW over a list of fp32 tensors in two kernel
// families: `sumsq_blocks` + `sumsq_finish`, the gradients' sum of squares
// in a fixed order, and `adamw_apply`, the whole update in one read of p,
// g, m, v and one write of p, m, v.
//
// Replaces no Pallas kernel: the JAX package leaves optax's update
// (clip_by_global_norm, then adamw; mvuld_tpu/core/optim.py) to XLA, which
// fuses it on the TPU. Here it takes the place of core/optim.py's
// per-tensor norm loop (one product, one sum and one add a tensor) and
// its chain of sixteen `torch._foreach_*` calls, five of them allocating a
// full-size temporary list: about 172 bytes a parameter where the update
// needs 32.
//
// Arithmetic (adamw_apply), per element, the `_foreach` chain's fp32
// roundings in its order, written with the _rn intrinsics so that nvcc
// contracts nothing the chain does not:
//
//   g = g * clip                      (when a clip factor is given)
//   m = m * b1 + g * omb1
//   v = v * b2 + (g * g) * omb2
//   u = (m / c1) / (sqrt(v / c2) + eps)
//   u = fma(wd, p, u)                 (decayed tensors: `_foreach_add_`'s
//                                      alpha functor forms a + alpha * b,
//                                      which PyTorch's build contracts)
//   p = p + u * neg_lr
//
// The coefficients are device fp32 scalars (the optimizer gates them on
// the device under MultiSteps), read by pointer; eps and wd are host
// floats. sumsq squares and adds in fp64 inside a block and over the
// blocks' partials, each block writing its own slot, so the norm repeats
// to the bit in eager steps and in graph replays.
//
// Design. Each launch carries a table of up to kTable tensors by value in
// its kernel parameters (under the 4 KB every CUDA 12 toolkit takes; a
// CUDA graph records it, nothing is copied from the host); the host side
// splits longer lists over several launches. Block b of a launch owns
// chunk b - start[t] (kChunk elements) of the tensor t whose block range
// holds b, found by a binary search over the table. Where the tensor's
// pointers all start on 16 bytes the block moves float4s, with a scalar
// tail; otherwise scalars.
//
// Bound: 28 bytes a parameter for the update (read p, g, m, v; write p,
// m, v) plus 4 for the norm's read of g, at 3.35 TB/s. The divisions and
// the square root take an estimated 2 ms of instructions over 0.93 B
// parameters, under the memory's 8.9 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32768;   // elements a block
constexpr int kTable = 84;      // tensors a launch

struct Table {
  float* p[kTable];
  const float* g[kTable];
  float* m[kTable];
  float* v[kTable];
  long long n[kTable];
  int start[kTable + 1];        // first block of each tensor; start[count]
  unsigned char decay[kTable];  //   is the launch's grid
  int count;
};

struct Coefs {                  // device pointers to fp32 scalars
  const float* clip;            // null: no clip
  const float* neg_lr;
  const float* c1;
  const float* c2;
  const float* b1;
  const float* omb1;
  const float* b2;
  const float* omb2;
  float eps, wd;
};

static_assert(sizeof(Table) + sizeof(Coefs) <= 4096,
              "the launch table must fit the 4 KB of kernel parameters");

// the tensor whose block range holds block b
__device__ __forceinline__ int locate(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

struct Step {
  float clip, neg_lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
  bool has_clip, decay;

  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v) const {
    if (has_clip) g = __fmul_rn(g, clip);
    m = __fadd_rn(__fmul_rn(m, b1), __fmul_rn(g, omb1));
    v = __fadd_rn(__fmul_rn(v, b2), __fmul_rn(__fmul_rn(g, g), omb2));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps);
    float u = __fdiv_rn(__fdiv_rn(m, c1), den);
    if (decay) u = __fmaf_rn(wd, p, u);
    p = __fadd_rn(p, __fmul_rn(u, neg_lr));
  }
};

__global__ void __launch_bounds__(kThreads)
    adamw_apply(const __grid_constant__ Table t,
                const __grid_constant__ Coefs c) {
  const int i = locate(t, blockIdx.x);
  const long long lo = (long long)(blockIdx.x - t.start[i]) * kChunk;
  const long long hi = min(lo + kChunk, t.n[i]);
  Step st;
  st.has_clip = c.clip != nullptr;
  st.clip = st.has_clip ? __ldg(c.clip) : 1.f;
  st.neg_lr = __ldg(c.neg_lr);
  st.c1 = __ldg(c.c1);
  st.c2 = __ldg(c.c2);
  st.b1 = __ldg(c.b1);
  st.omb1 = __ldg(c.omb1);
  st.b2 = __ldg(c.b2);
  st.omb2 = __ldg(c.omb2);
  st.eps = c.eps;
  st.wd = c.wd;
  st.decay = t.decay[i] != 0;
  float* P = t.p[i];
  const float* G = t.g[i];
  float* M = t.m[i];
  float* V = t.v[i];
  long long tail = lo;
  if (aligned16(P, G, M, V)) {
    tail = lo + ((hi - lo) & ~3LL);
    for (long long j = lo + 4 * threadIdx.x; j < tail; j += 4 * kThreads) {
      float4 p = *reinterpret_cast<const float4*>(P + j);
      const float4 g = __ldg(reinterpret_cast<const float4*>(G + j));
      float4 m = *reinterpret_cast<const float4*>(M + j);
      float4 v = *reinterpret_cast<const float4*>(V + j);
      st(p.x, g.x, m.x, v.x);
      st(p.y, g.y, m.y, v.y);
      st(p.z, g.z, m.z, v.z);
      st(p.w, g.w, m.w, v.w);
      *reinterpret_cast<float4*>(P + j) = p;
      *reinterpret_cast<float4*>(M + j) = m;
      *reinterpret_cast<float4*>(V + j) = v;
    }
  }
  for (long long j = tail + threadIdx.x; j < hi; j += kThreads) {
    float p = P[j], m = M[j], v = V[j];
    st(p, __ldg(G + j), m, v);
    P[j] = p;
    M[j] = m;
    V[j] = v;
  }
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the block's sum in a fixed order: each warp's by the same butterfly,
// then the warps' in index order by one thread
template <int kBlock>
__device__ __forceinline__ double block_sum_d(double v) {
  __shared__ double warps[kBlock / 32];
  v = warp_sum_d(v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kBlock / 32; ++w) s += warps[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
    sumsq_blocks(const __grid_constant__ Table t, double* __restrict__ part) {
  const int i = locate(t, blockIdx.x);
  const long long lo = (long long)(blockIdx.x - t.start[i]) * kChunk;
  const long long hi = min(lo + kChunk, t.n[i]);
  const float* G = t.g[i];
  double acc = 0.0;
  long long tail = lo;
  if ((reinterpret_cast<uintptr_t>(G) & 15) == 0) {
    tail = lo + ((hi - lo) & ~3LL);
    for (long long j = lo + 4 * threadIdx.x; j < tail; j += 4 * kThreads) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(G + j));
      acc = fma((double)g.x, (double)g.x, acc);
      acc = fma((double)g.y, (double)g.y, acc);
      acc = fma((double)g.z, (double)g.z, acc);
      acc = fma((double)g.w, (double)g.w, acc);
    }
  }
  for (long long j = tail + threadIdx.x; j < hi; j += kThreads) {
    const double g = __ldg(G + j);
    acc = fma(g, g, acc);
  }
  const double s = block_sum_d<kThreads>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

constexpr int kFinish = 1024;

__global__ void __launch_bounds__(kFinish)
    sumsq_finish(const double* __restrict__ part, long long count,
                 float* __restrict__ out) {
  double acc = 0.0;
  for (long long k = threadIdx.x; k < count; k += kFinish) acc += part[k];
  const double s = block_sum_d<kFinish>(acc);
  if (threadIdx.x == 0) *out = (float)s;
}

long long blocks_of(long long n) { return (n + kChunk - 1) / kChunk; }

// the table of tensors [first, first + count): sizes, block starts, and
// the pointer lists that are given
void fill(Table& t, int first, int count, void* const* p, void* const* g,
          void* const* m, void* const* v, const long long* numel,
          const unsigned char* decay) {
  t.count = count;
  int blocks = 0;
  for (int k = 0; k < count; ++k) {
    const int i = first + k;
    t.p[k] = p ? static_cast<float*>(p[i]) : nullptr;
    t.g[k] = static_cast<const float*>(g[i]);
    t.m[k] = m ? static_cast<float*>(m[i]) : nullptr;
    t.v[k] = v ? static_cast<float*>(v[i]) : nullptr;
    t.n[k] = numel[i];
    t.decay[k] = decay ? decay[i] : 0;
    t.start[k] = blocks;
    blocks += static_cast<int>(blocks_of(numel[i]));
  }
  t.start[count] = blocks;
}

}  // namespace

// the partial slots `optim_sumsq` writes for these sizes: one a block
extern "C" long long optim_sumsq_slots(int n, const long long* numel) {
  long long s = 0;
  for (int i = 0; i < n; ++i) s += blocks_of(numel[i]);
  return s;
}

// *out = sum over the n tensors g[i] (numel[i] fp32 values each) of g^2,
// in fp64 and a fixed order, rounded to fp32; `part` holds
// optim_sumsq_slots doubles
extern "C" int optim_sumsq(int n, void* const* g, const long long* numel,
                           void* part, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* slots = static_cast<double*>(part);
  long long used = 0;
  for (int first = 0; first < n; first += kTable) {
    Table t;
    fill(t, first, std::min(kTable, n - first), nullptr, g, nullptr, nullptr,
         numel, nullptr);
    if (t.start[t.count] == 0) continue;
    sumsq_blocks<<<t.start[t.count], kThreads, 0, s>>>(t, slots + used);
    used += t.start[t.count];
  }
  sumsq_finish<<<1, kFinish, 0, s>>>(slots, used, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// one AdamW step over the n tensors p[i] (in place, with their moments
// m[i] and v[i]) from the gradients g[i], all fp32 with numel[i] values;
// `coefs` holds the device pointers clip (or null), neg_lr, c1, c2, b1,
// omb1, b2, omb2
extern "C" int optim_adamw(int n, void* const* p, void* const* g,
                           void* const* m, void* const* v,
                           const long long* numel, const unsigned char* decay,
                           void* const* coefs, float eps, float wd,
                           void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Coefs c;
  c.clip = static_cast<const float*>(coefs[0]);
  c.neg_lr = static_cast<const float*>(coefs[1]);
  c.c1 = static_cast<const float*>(coefs[2]);
  c.c2 = static_cast<const float*>(coefs[3]);
  c.b1 = static_cast<const float*>(coefs[4]);
  c.omb1 = static_cast<const float*>(coefs[5]);
  c.b2 = static_cast<const float*>(coefs[6]);
  c.omb2 = static_cast<const float*>(coefs[7]);
  c.eps = eps;
  c.wd = wd;
  for (int first = 0; first < n; first += kTable) {
    Table t;
    fill(t, first, std::min(kTable, n - first), p, g, m, v, numel, decay);
    if (t.start[t.count] == 0) continue;
    adamw_apply<<<t.start[t.count], kThreads, 0, s>>>(t, c);
  }
  return static_cast<int>(cudaGetLastError());
}
