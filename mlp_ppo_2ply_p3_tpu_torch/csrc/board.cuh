// Board rules shared by the movegen kernels (doubles.cu, nondoubles.cu):
// one die's 27 submove slots of a canonical board, and the afterstate of one
// submove, bit for bit as the plain PyTorch rules compute them.
//
// A board is 52 int8 counts in the mover's frame: my points 0..23, the
// opponent's points 24..47, my bar 48, the opponent's bar 49, my off 50, the
// opponent's off 51; the mover travels 0 -> 23, enters on die - 1 and bears
// off past 23.  Slots follow core/board.py::submoves_one_die (24 points, the
// bar, the farthest bear-off, the exact bear-off from 24 - die) with its
// index clamps and its sentinel 99 for "no checker at home"; the afterstate
// is core/board.py::apply_submove, in int8 arithmetic.  A mirrored game scans
// the bar first, then points 23..0, then the two bear-off slots
// (ops/doubles.py::perm_scan): scan_order() and scan_slot() map between the
// two orders with one bit reversal.
//
// Each source that includes this header is its own library, so everything
// here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 27;
constexpr int kBoard = 52;
constexpr int kWords = kBoard / 4;        // 13
constexpr int kPoints = 24;
constexpr int kCheckers = 15;
constexpr int kOriginBar = 24;
constexpr int kDestOff = 24;
constexpr int kNoChecker = 99;            // submoves_one_die's sentinel
constexpr int kMyBar = 48, kOppBar = 49, kMyOff = 50;
constexpr uint32_t kPointsAndBar = (1u << 25) - 1u;

__device__ __forceinline__ int clamp_pt(int x) {
  return x < 0 ? 0 : (x > kPoints - 1 ? kPoints - 1 : x);
}

// ops/doubles.py::rank_of as int8
__device__ __forceinline__ int rank_of(int origin) {
  return (int)(int8_t)(origin == kOriginBar ? -1 : origin);
}

// Farthest occupied home point (18..23), or the sentinel.
__device__ __forceinline__ int farthest_home(const int8_t* b) {
  int far = kNoChecker;
#pragma unroll
  for (int p = kPoints - 1; p >= 18; --p) {
    if (b[p] > 0) far = p;
  }
  return far;
}

// Bit s: slot s (unpermuted) is a valid submove of board b whose rank is
// at least `parent` (no rank filter unless `filter`).
__device__ uint32_t slot_mask(const int8_t* b, int die, int parent,
                              bool filter) {
  const bool on_bar = b[kMyBar] > 0;
  const bool live = b[kMyOff] < kCheckers;
  if (!live) return 0u;
  int home_sum = 0;
#pragma unroll
  for (int p = 0; p < 18; ++p) home_sum += b[p];
  const bool all_home = !on_bar && home_sum == 0;
  uint32_t m = 0u;
  if (!on_bar) {
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      const int dp = p + die;
      const bool in_board = dp < kPoints;
      const int opp_at = in_board ? b[kPoints + clamp_pt(dp)] : 0;
      if (b[p] > 0 && in_board && opp_at <= 1 && (!filter || p >= parent)) {
        m |= 1u << p;
      }
    }
  } else if (b[kPoints + clamp_pt(die - 1)] <= 1 && (!filter || -1 >= parent)) {
    m |= 1u << kOriginBar;
  }
  if (all_home) {
    const int far = farthest_home(b);
    if (far < kNoChecker && far + die >= kPoints) {
      const int o = far < 18 ? 18 : (far > 23 ? 23 : far);
      if (!filter || o >= parent) m |= 1u << 25;
    }
    const int ex = kPoints - die;
    if (b[clamp_pt(ex)] > 0 && ex != far &&
        (!filter || rank_of(ex) >= parent)) {
      m |= 1u << 26;
    }
  }
  return m;
}

// A slot mask in the game's scan order (bit i: the i-th slot scanned).
__device__ __forceinline__ uint32_t scan_order(uint32_t m, bool mirror) {
  return mirror ? (m & ~kPointsAndBar) | (__brev(m & kPointsAndBar) >> 7) : m;
}

// The slot at scan-order bit s.
__device__ __forceinline__ int scan_slot(int s, bool mirror) {
  return (mirror && s < 25) ? 24 - s : s;
}

// (row, origin, dest, hit) of a valid slot, packed: row in bits 0-7,
// origin and dest as int8 in bits 8-15 and 16-23, hit in bit 24.
__device__ __forceinline__ uint32_t slot_item(const int8_t* b, int row,
                                              int slot, int die) {
  int o, d, h = 0;
  if (slot < kPoints) {
    o = slot;
    d = slot + die;          // in the board: the slot is valid
    h = b[kPoints + clamp_pt(d)] == 1;
  } else if (slot == kOriginBar) {
    o = kOriginBar;
    d = die - 1;
    h = b[kPoints + clamp_pt(d)] == 1;
  } else if (slot == 25) {
    const int far = farthest_home(b);
    o = far < 18 ? 18 : (far > 23 ? 23 : far);
    d = kDestOff;
  } else {
    o = kPoints - die;
    d = kDestOff;
  }
  return (uint32_t)row | ((uint32_t)(uint8_t)(int8_t)o << 8) |
         ((uint32_t)(uint8_t)(int8_t)d << 16) | ((uint32_t)h << 24);
}

// The item of row `row` itself, no submove applied (origin and dest -1
// match no slot of the board).
__device__ __forceinline__ uint32_t identity_item(int row) {
  return (uint32_t)row | (0xffu << 8) | (0xffu << 16);
}

// Byte p of apply_submove(b, o, d, h), in int8 arithmetic.
__device__ __forceinline__ uint32_t after_byte(const int8_t* b, int p, int o,
                                               int d, int h) {
  int v = b[p];
  if (p < kPoints) {
    v += (p == d) - (p == o);
  } else if (p < 2 * kPoints) {
    v -= (p - kPoints == d) & h;
  } else if (p == kMyBar) {
    v -= o == kOriginBar;
  } else if (p == kOppBar) {
    v += h;
  } else if (p == kMyOff) {
    v += d == kDestOff;
  }
  return (uint32_t)(uint8_t)(int8_t)v;
}

// Word w (bytes 4w..4w+3) of the afterstate that an item names, from the
// item's parent board pb.
__device__ __forceinline__ uint32_t after_word(const int8_t* pb,
                                               uint32_t item, int w) {
  const int o = (int8_t)(item >> 8), d = (int8_t)(item >> 16);
  const int h = (item >> 24) & 1;
  uint32_t word = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    word |= after_byte(pb, 4 * w + q, o, d, h) << (8 * q);
  }
  return word;
}

// Exclusive prefix of v over a block of kWarps warps; `total` gets the sum.
// The caller syncs before warp_tot is written again.
template <int kWarps>
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  return before + x - v;
}

// Store `words` zero words from dst (4-byte aligned), 16 bytes a store
// between the aligned head and tail; threads t of n share the work.
__device__ __forceinline__ void zero_words(uint32_t* dst, long long words,
                                           int t, int n) {
  if (words <= 0) return;
  const int head = (int)((16 - ((uintptr_t)dst & 15)) & 15) / 4;
  const long long h = head < words ? head : words;
  if (t < h) dst[t] = 0u;
  uint4* v = reinterpret_cast<uint4*>(dst + h);
  const long long nv = (words - h) / 4;
  for (long long i = t; i < nv; i += n) v[i] = make_uint4(0u, 0u, 0u, 0u);
  const long long rest = h + 4 * nv;
  if (t < words - rest) dst[rest + t] = 0u;
}

}  // namespace
