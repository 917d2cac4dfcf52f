// The optimizer step of the PPO update for Hopper (sm_90a): optax's
// clip_by_global_norm -> scale_by_adam -> scale(-lr) over every leaf of the
// model, in two launches.  Per element of leaf i, with the global norm
// N = sqrt(sum over every leaf of g * g) and c = count + 1:
//
//   g' = g                          if N < max_norm (or clipping is off)
//        (g / N) * max_norm         otherwise
//   m' = (1 - b1) g' + b1 m
//   v' = (1 - b2) (g' g') + b2 v
//   p  = p + ((m' / bc1) / (sqrt(v' / bc2) + eps)) (-lr)
//
// where bc1 = 1 - b1^c and bc2 = 1 - b2^c; count' = c.  m' and v' go to new
// buffers (the old optimizer state is left as it was), p is updated in
// place.
//
// It replaces no TPU kernel: the JAX package's update is optax's chain
// (mlp_ppo_2ply_p3_tpu/ppo/learner.py:102-106), which XLA fuses.  The
// port's plain twin (ops/adam.py::adam_update_plain) runs the same arithmetic as
// about 170 ATen launches a step, one or more per leaf and operation.
//
// What bounds it on this card.  A step reads p, g, m and v and writes p, m
// and v: 28 bytes a parameter, 1.65 MB for afterstate4096's 58,754
// parameters, 0.49 us at 3.35 TB/s.  That is less than the latency of one
// launch, so the design is about launches and round trips to memory:
//
// - Every leaf in one grid.  The kernels take a table of the leaves'
//   pointers and sizes by value (at most kMaxLeaves), cut into blocks of
//   kBlockElems elements that each lie inside one leaf; a block finds its
//   leaf by scanning the table's first-block column.  The leaves stay
//   separate tensors: nothing is copied into a flat buffer.
// - The global norm without atomics.  Launch 1 writes one partial sum of
//   g * g a block.  Launch 2 starts each thread's loads of its elements,
//   then every block sums the partials in the same fixed order (a thread a
//   strided run, then a fixed shuffle tree), so every block gets the same
//   norm and the result is the same on every run.  With clipping off
//   launch 1 is skipped.
// - No host synchronisation: the step count is read and written on the
//   device; nothing is sized from a device value.
//
// Arithmetic.  Each element's operations run in the plain twin's order and
// rounding, one IEEE operation each, with the intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so that nvcc contracts
// nothing into an FMA; the bias corrections use powf, as torch.pow does
// for float32.  The constants are the plain twin's Python scalars cast to
// float32, as torch casts them.  So the only difference from the plain
// twin is the order in which the global norm is summed; with clipping off
// or not engaged the results are the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlockElems = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 24;

// The leaves, passed by value (under 1.5 KB of kernel parameters).  Leaf i
// takes blocks first[i] .. first[i + 1] - 1.
struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  const float* m[kMaxLeaves];
  const float* v[kMaxLeaves];
  float* m_out[kMaxLeaves];
  float* v_out[kMaxLeaves];
  int n[kMaxLeaves];
  int first[kMaxLeaves + 1];
  int leaves;
};

struct Consts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, neg_lr, max_norm;
};

// The leaf whose blocks hold `block` (leaves of no block are passed over).
__device__ __forceinline__ int leaf_of(const Leaves& t, int block) {
  int i = 0;
  while (i + 1 < t.leaves && t.first[i + 1] <= block) ++i;
  return i;
}

// Sum of x over the block, the same bits in every block for the same
// inputs: a fixed shuffle tree, then the warps' sums in warp order.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, d));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// Launch 1: partial[b] = the sum of g * g over block b's elements.
__global__ void __launch_bounds__(kThreads)
    adam_norm_kernel(const Leaves t, float* __restrict__ partial) {
  __shared__ float red[kWarps];
  const int b = blockIdx.x;
  const int i = leaf_of(t, b);
  const float* __restrict__ g = t.g[i];
  const int base = (b - t.first[i]) * kBlockElems + threadIdx.x;
  const int n = t.n[i];
  float x[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = base + k * kThreads;
    x[k] = e < n ? g[e] : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) s = __fadd_rn(s, __fmul_rn(x[k], x[k]));
  s = block_sum(s, red);
  if (threadIdx.x == 0) partial[b] = s;
}

// Launch 2: the clip, the moments and the parameters of block b's
// elements; block 0 writes the new count.
__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const Leaves t, const float* __restrict__ partial,
                       int clip, const int* __restrict__ count_in,
                       int* __restrict__ count_out, const Consts c) {
  __shared__ float red[kWarps];
  const int b = blockIdx.x;
  const int i = leaf_of(t, b);
  float* __restrict__ p = t.p[i];
  const float* __restrict__ g = t.g[i];
  const float* __restrict__ m = t.m[i];
  const float* __restrict__ v = t.v[i];
  const int base = (b - t.first[i]) * kBlockElems + threadIdx.x;
  const int n = t.n[i];

  float pv[kPerThread], gv[kPerThread], mv[kPerThread], vv[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = base + k * kThreads;
    if (e < n) {
      pv[k] = p[e];
      gv[k] = g[e];
      mv[k] = m[e];
      vv[k] = v[e];
    }
  }

  // int32 wraps as torch's int32 add does
  const int step = (int)((unsigned)*count_in + 1u);
  if (b == 0 && threadIdx.x == 0) *count_out = step;
  const float cf = (float)step;
  const float bc1 = __fsub_rn(1.f, powf(c.b1, cf));
  const float bc2 = __fsub_rn(1.f, powf(c.b2, cf));

  bool keep = true;
  float norm = 0.f;
  if (clip) {
    const int blocks = t.first[t.leaves];
    float s = 0.f;
    for (int j = threadIdx.x; j < blocks; j += kThreads)
      s = __fadd_rn(s, partial[j]);
    norm = __fsqrt_rn(block_sum(s, red));
    keep = norm < c.max_norm;
  }

  float* __restrict__ m_out = t.m_out[i];
  float* __restrict__ v_out = t.v_out[i];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = base + k * kThreads;
    if (e < n) {
      const float gk =
          keep ? gv[k] : __fmul_rn(__fdiv_rn(gv[k], norm), c.max_norm);
      const float m1 =
          __fadd_rn(__fmul_rn(c.one_minus_b1, gk), __fmul_rn(c.b1, mv[k]));
      const float v1 = __fadd_rn(__fmul_rn(c.one_minus_b2, __fmul_rn(gk, gk)),
                                 __fmul_rn(c.b2, vv[k]));
      const float upd = __fdiv_rn(
          __fdiv_rn(m1, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, bc2)), c.eps));
      p[e] = __fadd_rn(pv[k], __fmul_rn(upd, c.neg_lr));
      m_out[e] = m1;
      v_out[e] = v1;
    }
  }
}

}  // namespace

// One optimizer step on the current stream.  Pointer tables of `leaves`
// entries: p (updated in place), g, m, v (read) and m_out, v_out (written);
// n the leaves' sizes and first (leaves + 1 entries) their first blocks, as
// ops/adam.py::block_layout cuts them (checked here against kBlockElems).
// partial holds first[leaves] floats (unused with clip 0).  Returns the
// CUDA error of the first launch that failed, or 0.
extern "C" int adam_launch(void* const* p, const void* const* g,
                           const void* const* m, const void* const* v,
                           void* const* m_out, void* const* v_out,
                           const int* n, const int* first, int leaves,
                           const void* count_in, void* count_out,
                           void* partial, int clip, float b1,
                           float one_minus_b1, float b2, float one_minus_b2,
                           float eps, float neg_lr, float max_norm,
                           void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || first[0] != 0)
    return (int)cudaErrorInvalidValue;
  Leaves t;
  t.leaves = leaves;
  t.first[0] = 0;
  for (int i = 0; i < leaves; ++i) {
    const int want = (int)(((long long)n[i] + kBlockElems - 1) /
                           kBlockElems);
    if (n[i] < 0 || first[i + 1] - first[i] != want)
      return (int)cudaErrorInvalidValue;
    t.p[i] = (float*)p[i];
    t.g[i] = (const float*)g[i];
    t.m[i] = (const float*)m[i];
    t.v[i] = (const float*)v[i];
    t.m_out[i] = (float*)m_out[i];
    t.v_out[i] = (float*)v_out[i];
    t.n[i] = n[i];
    t.first[i + 1] = first[i + 1];
  }
  const int blocks = first[leaves];
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const Consts c{b1, one_minus_b1, b2, one_minus_b2, eps, neg_lr, max_norm};
  cudaStream_t s = (cudaStream_t)stream;
  if (clip) {
    adam_norm_kernel<<<blocks, kThreads, 0, s>>>(t, (float*)partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  adam_update_kernel<<<blocks, kThreads, 0, s>>>(
      t, (const float*)partial, clip, (const int*)count_in, (int*)count_out,
      c);
  return (int)cudaGetLastError();
}
