// Whole rows, shared by the afterstate pass (afterstate.cu) and the dense
// layers (dense.cu).  Under the logits epilogue a row with n <= 0 keeps every
// slot, and a row with no legal move holds one board in all m slots; such a
// row, every board equal to slot 0, is whole: one kept board whose value
// goes into each of the row's m slots, and whose cotangent is the row's m
// cotangents summed.  Both helpers work a warp a row, the warp's lanes all
// present.
//
// Each source that includes this header is its own library, so everything
// here has internal linkage.

#pragma once

#include <cuda_runtime.h>

namespace {

// The m floats of row summed over the warp in a fixed order: each lane its
// entries lane, lane + 32, ... in order, then a butterfly over the lanes
// (every lane gets the same bits).
__device__ __forceinline__ float warp_row_sum(const float* row, int m) {
  float sum = 0.0f;
  for (int sl = (int)(threadIdx.x & 31); sl < m; sl += 32) sum += row[sl];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// Lanes whose row is whole (whole, its first element e = r m) write v into
// each of its m slots of out: the warp a row at a time, coalesced.
__device__ __forceinline__ void write_whole_rows(float* out, int m, int e,
                                                 bool whole, float v) {
  for (unsigned rows = __ballot_sync(0xffffffffu, whole); rows;
       rows &= rows - 1) {
    const int src = __ffs(rows) - 1;
    const size_t base = (size_t)__shfl_sync(0xffffffffu, e, src);
    const float x = __shfl_sync(0xffffffffu, v, src);
    for (int sl = (int)(threadIdx.x & 31); sl < m; sl += 32) {
      out[base + sl] = x;
    }
  }
}

// Lanes whose row is whole (whole, its first element e = r m) get its m
// entries of grad summed (warp_row_sum), the others keep v: the warp a row
// at a time.
__device__ __forceinline__ float whole_row_grad(const float* grad, int m,
                                                int e, bool whole, float v) {
  for (unsigned rows = __ballot_sync(0xffffffffu, whole); rows;
       rows &= rows - 1) {
    const int src = __ffs(rows) - 1;
    const size_t base = (size_t)__shfl_sync(0xffffffffu, e, src);
    const float sum = warp_row_sum(grad + base, m);
    if ((int)(threadIdx.x & 31) == src) v = sum;
  }
  return v;
}

}  // namespace
