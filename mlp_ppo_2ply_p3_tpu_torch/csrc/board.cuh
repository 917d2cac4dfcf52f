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
// The rules work on a board's 13 words, not its bytes: four byte compares a
// word (__vcmpgts4, __vcmpeq4) give the bit sets that the slot predicate
// reads (my occupied points, the opponent's blocks and blots), so a slot
// mask is a few shifts and ands; an afterstate word is its parent's word plus
// the submove's byte deltas (__vadd4).  Dice lie in 0..6.
//
// Each source that includes this header is its own library, so everything
// here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 27;
constexpr int kMaxDevices = 64;           // launch settings kept per card
constexpr int kBoard = 52;
constexpr int kWords = kBoard / 4;        // 13
constexpr int kPoints = 24;
constexpr int kCheckers = 15;
constexpr int kOriginBar = 24;
constexpr int kDestOff = 24;
constexpr int kNoChecker = 99;            // submoves_one_die's sentinel
constexpr int kMyOff = 50;
constexpr uint32_t kPointsAndBar = (1u << 25) - 1u;

__device__ __forceinline__ int clamp_pt(int x) {
  return x < 0 ? 0 : (x > kPoints - 1 ? kPoints - 1 : x);
}

// ops/doubles.py::rank_of as int8
__device__ __forceinline__ int rank_of(int origin) {
  return (int)(int8_t)(origin == kOriginBar ? -1 : origin);
}

// What the slot predicate reads of a board.
struct Bits {
  uint32_t mine;     // bit p: my point p holds a checker (count > 0)
  uint32_t blocked;  // bit q: the opponent holds point q with 2 or more
  uint32_t blot;     // bit q: the opponent holds point q with exactly 1
  int home_sum;      // my points 0..17, summed
  int bar, off;      // my bar and my off counts
};

// 0xff / 0x00 bytes -> one bit a byte.
__device__ __forceinline__ uint32_t byte_bits(uint32_t cmp) {
  return ((cmp & 0x08040201u) * 0x01010101u) >> 24;
}

// The bits of the board whose 13 words start at row (4-byte aligned).
__device__ __forceinline__ Bits row_bits(const uint32_t* row) {
  Bits s;
  s.mine = s.blocked = s.blot = 0u;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const uint32_t mw = row[i], ow = row[6 + i];
    s.mine |= byte_bits(__vcmpgts4(mw, 0u)) << (4 * i);
    s.blocked |= byte_bits(__vcmpgts4(ow, 0x01010101u)) << (4 * i);
    s.blot |= byte_bits(__vcmpeq4(ow, 0x01010101u)) << (4 * i);
  }
  int home = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) home = __dp4a((int)row[i], 0x01010101, home);
  s.home_sum = __dp4a((int)row[4], 0x00000101, home);     // points 16, 17
  const uint32_t tail = row[12];
  s.bar = (int8_t)(tail & 0xffu);
  s.off = (int8_t)((tail >> 16) & 0xffu);
  return s;
}

// Farthest occupied home point (18..23), or the sentinel.
__device__ __forceinline__ int farthest_home(const Bits& s) {
  const uint32_t home = (s.mine >> 18) & 0x3fu;
  return home ? 17 + __ffs(home) : kNoChecker;
}

// Bit s: slot s (unpermuted) is a valid submove of the board whose rank is
// at least `parent` (no rank filter unless `filter`).
__device__ __forceinline__ uint32_t slot_mask(const Bits& s, int die,
                                              int parent, bool filter) {
  if (s.off >= kCheckers) return 0u;
  const bool on_bar = s.bar > 0;
  uint32_t keep = 0xffffffffu;               // points p >= parent
  if (filter) keep = parent <= 0 ? keep : (parent > 24 ? 0u : keep << parent);
  uint32_t m = 0u;
  if (!on_bar) {
    // p + die on the board, and not blocked there
    m = s.mine & (0xffffffu >> die) & ~(s.blocked >> die) & keep & 0xffffffu;
  } else if (!((s.blocked >> clamp_pt(die - 1)) & 1u) &&
             (!filter || -1 >= parent)) {
    m = 1u << kOriginBar;
  }
  if (!on_bar && s.home_sum == 0) {          // all home
    const int far = farthest_home(s);
    if (far < kNoChecker && far + die >= kPoints &&
        (!filter || far >= parent)) {
      m |= 1u << 25;
    }
    const int ex = kPoints - die;
    if (((s.mine >> clamp_pt(ex)) & 1u) && ex != far &&
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
__device__ __forceinline__ uint32_t slot_item(const Bits& s, int row,
                                              int slot, int die) {
  int o, d, h = 0;
  if (slot < kPoints) {
    o = slot;
    d = slot + die;          // in the board: the slot is valid
    h = (s.blot >> clamp_pt(d)) & 1u;
  } else if (slot == kOriginBar) {
    o = kOriginBar;
    d = die - 1;
    h = (s.blot >> clamp_pt(d)) & 1u;
  } else if (slot == 25) {
    const int far = farthest_home(s);
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

// Word w (bytes 4w..4w+3) of the afterstate that an item names, from word w
// of its parent: +1 on my point dest, -1 on my point origin, -1 on the
// opponent's point dest if hit; my bar -1 from the bar, the opponent's bar +1
// if hit, my off +1 bearing off; bytewise, in int8 arithmetic.
__device__ __forceinline__ uint32_t after_word(uint32_t word, uint32_t item,
                                               int w) {
  const int o = (int8_t)(item >> 8), d = (int8_t)(item >> 16);
  const uint32_t h = (item >> 24) & 1u;
  const bool d_point = d >= 0 && d < kPoints;
  uint32_t delta = 0u;
  if (w < 6) {
    if (d_point && (d >> 2) == w) delta = 1u << (8 * (d & 3));
    if (o >= 0 && o < kPoints && (o >> 2) == w) {
      delta = __vadd4(delta, 0xffu << (8 * (o & 3)));
    }
  } else if (w < 12) {
    if (h && d_point && (d >> 2) == w - 6) delta = 0xffu << (8 * (d & 3));
  } else {
    delta = (o == kOriginBar ? 0xffu : 0u) | (h << 8) |
            (d == kDestOff ? 0x10000u : 0u);
  }
  return __vadd4(word, delta);
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
