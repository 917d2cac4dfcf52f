// Batched stable compaction for Hopper (sm_90a): the movegen hot op.
//
// Replaces both Pallas TPU kernels of mlp_ppo_2ply_p3_tpu/ops/compaction.py
// (compact_rows, the one-hot int8 matmul; compact_rows_segmented, the
// 128-wide segmented one-hot).  Both compute one function:
//
//   payload (B, N, C) int8, valid (B, N) uint8/bool, k_out
//   -> out (B, k_out, C) int8: the valid rows of each batch row, in their
//      original order, then zeros;
//      count (B,) int32: the number of valid rows (may exceed k_out).
//
// Design: one CTA per batch row walks N in chunks of blockDim.x.  A warp
// ballot + popc gives each flag's rank inside its warp, a shared-memory
// scan over the warp totals gives the chunk-local slot, and the chunk's
// surviving source indices are listed in shared memory so the whole CTA
// copies their C-byte rows cooperatively (consecutive threads on
// consecutive bytes of the output).  The tail [min(count, k_out), k_out)
// is zero-filled, since the caller allocates `out` uninitialised.
//
// Bound on the card: bytes.  The function reads the valid flags (B*N
// bytes) and the payload rows that land in `out`, and writes out and
// count; it does no arithmetic worth counting.  The TPU's one-hot matmul,
// segments and 8-aligned merges were workarounds for the MXU and Mosaic
// and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const int8_t* __restrict__ payload,
                    const uint8_t* __restrict__ valid,
                    int8_t* __restrict__ out,
                    int32_t* __restrict__ count,
                    int n, int c, int k_out) {
  __shared__ int warp_total[kWarps];
  __shared__ int src[kThreads];

  const int b = blockIdx.x;
  const int8_t* pay = payload + (size_t)b * n * c;
  const uint8_t* v = valid + (size_t)b * n;
  int8_t* o = out + (size_t)b * k_out * c;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  int base = 0;  // valid rows seen before this chunk (block-uniform)
  for (int start = 0; start < n; start += kThreads) {
    const int i = start + threadIdx.x;
    const bool flag = (i < n) && (v[i] != 0);
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();

    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_total[w];
      before += (w < warp) ? t : 0;
      total += t;
    }
    const int local = before + __popc(ballot & lanes_below);
    if (flag) src[local] = i;
    __syncthreads();

    // rows of this chunk that still fit in the output
    int keep = k_out - base;
    keep = keep < 0 ? 0 : (keep < total ? keep : total);
    const int bytes = keep * c;
    int8_t* dst = o + (size_t)base * c;
    for (int e = threadIdx.x; e < bytes; e += kThreads) {
      const int r = e / c;
      const int col = e - r * c;
      dst[e] = pay[(size_t)src[r] * c + col];
    }
    base += total;
    __syncthreads();  // src and warp_total are rewritten next chunk
  }

  const int filled = base < k_out ? base : k_out;
  for (int e = filled * c + threadIdx.x; e < k_out * c; e += kThreads) {
    o[e] = 0;
  }
  if (threadIdx.x == 0) count[b] = base;
}

}  // namespace

extern "C" int compact_rows_launch(const void* payload, const void* valid,
                                   void* out, void* count, int batch, int n,
                                   int c, int k_out, void* stream) {
  if (batch > 0) {
    compact_rows_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)payload, (const uint8_t*)valid, (int8_t*)out,
        (int32_t*)count, n, c, k_out);
  }
  return (int)cudaGetLastError();
}
