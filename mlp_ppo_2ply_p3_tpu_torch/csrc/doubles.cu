// One level of movegen's doubles frontier for Hopper (sm_90a): expand every
// frontier row by the die over the 27 submove slots, in the reference's scan
// order, keep the expansions whose origin rank does not fall below the row's
// own, and stable-compact them into the next frontier.
//
// doubles_level_launch replaces the jnp `level` of the JAX package's doubles
// frontier, mlp_ppo_2ply_p3_tpu/core/movegen.py:406-416 (its compaction is
// the Pallas compact_rows, mlp_ppo_2ply_p3_tpu/ops/compaction.py:231, under
// use_pallas).  Per game g:
//
//   boards (G, K, 52) int8, parent ranks (G, K) int8, n_in (G,) int32 (row
//   k is valid iff k < min(n_in, K); ranks and n_in both null: a root
//   level, all K rows valid, no rank filter), die (G,) int32 in 0..6,
//   mirror (G,) uint8/bool
//   -> boards_out (G, k_out, 52) int8 and ranks_out (G, k_out) int8: the
//      valid candidates in (frontier row, scan position) order, then zeros;
//      n (G,) int32: the number of valid candidates (may exceed k_out).
//
// Slots follow core/board.py::submoves_one_die (24 points, the bar, the
// farthest bear-off, the exact bear-off from 24 - die) with its index clamps
// and its sentinel 99 for "no checker at home"; the afterstate is
// core/board.py::apply_submove, in int8 arithmetic.  Mirrored games scan the
// bar first, then points 23..0, then the two bear-off slots
// (ops/doubles.py::perm_scan).
//
// What bounds it on this card: bytes, and at movegen's sizes latency.  The
// function must read the valid frontier rows and write the next frontier:
// about 27 MB over the four levels of a `fast` movegen call at B=4096 (39 MB
// if every frontier row were read), 8 us at 3.35 TB/s.  The candidate grid it replaces, (G, K x 27, 53) before the
// compaction (240 MB at the last level), is what cost the time.  What the
// design does about it:
//
// - One block per game.  The block walks the frontier's VALID rows only, 128
//   rows a chunk (any K), staging each chunk in shared memory with 4-byte
//   loads (bytes where the boards do not start on a 4-byte boundary).
// - One thread per frontier row computes the row's 27-bit mask of valid,
//   rank-filtered slots in registers, permutes it into scan order with one
//   bit reversal, and counts it with popc.  A block-wide exclusive scan of
//   the counts (warp shuffles, one barrier) gives each row its first output
//   slot; the running count carries across chunks.
// - Each landing candidate (output slot < k_out) is listed in shared memory
//   as (row, origin, dest, hit).  Half-warps then write one output row each:
//   lane l computes the afterstate's word l (bytes 4l..4l+3) from the staged
//   parent and stores it, so 13 lanes write one 52-byte row in one coalesced
//   store; lane 13 writes its rank.  No candidate grid, valid mask or rank
//   array ever reaches device memory.
// - The zero tail is written with 4-byte stores.  Rows at or past k_out are
//   counted and never written.
//
// Nothing here allocates: the caller passes the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // a block: rows of a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kSlots = 27;
constexpr int kBoard = 52;
constexpr int kWords = kBoard / 4;        // 13
constexpr int kMaxItems = kThreads * kSlots;
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
// at least `parent` (no filter for a root level).
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

struct Smem {
  uint32_t rows[kThreads * kWords];  // the chunk's frontier rows
  uint32_t items[kMaxItems];         // the chunk's landing candidates
  int warp_tot[kWarps];
};

// Exclusive prefix of v over the block; `total` gets the sum.  The caller
// syncs before warp_tot is written again.
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

__global__ void __launch_bounds__(kThreads)
doubles_level_kernel(const int8_t* __restrict__ boards,
                     const int8_t* __restrict__ ranks,
                     const int32_t* __restrict__ n_in,
                     const int32_t* __restrict__ dice,
                     const uint8_t* __restrict__ mirror,
                     int8_t* __restrict__ boards_out,
                     int8_t* __restrict__ ranks_out,
                     int32_t* __restrict__ n_out, int k, int k_out,
                     int words) {
  __shared__ Smem sm;
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int hw = t >> 4, hl = t & 15;
  const int die = dice[g];
  const bool mir = mirror[g] != 0;
  const bool filter = ranks != nullptr;
  int nv = k;
  if (n_in != nullptr) nv = max(0, min(n_in[g], k));
  const int8_t* src = boards + (size_t)g * k * kBoard;
  const int8_t* rsrc = filter ? ranks + (size_t)g * k : nullptr;
  int8_t* out = boards_out + (size_t)g * k_out * kBoard;
  int8_t* rout = ranks_out + (size_t)g * k_out;
  const int8_t* rows = reinterpret_cast<const int8_t*>(sm.rows);

  int seen = 0;  // valid candidates of the earlier chunks
  for (int c0 = 0; c0 < nv; c0 += kThreads) {
    const int nrows = min(kThreads, nv - c0);
    __syncthreads();  // the last chunk's writers are done with sm
    if (words) {
      const uint32_t* s =
          reinterpret_cast<const uint32_t*>(src + (size_t)c0 * kBoard);
      for (int w = t; w < nrows * kWords; w += kThreads) sm.rows[w] = __ldg(s + w);
    } else {
      int8_t* r = reinterpret_cast<int8_t*>(sm.rows);
      const int8_t* s = src + (size_t)c0 * kBoard;
      for (int e = t; e < nrows * kBoard; e += kThreads) r[e] = s[e];
    }
    __syncthreads();

    uint32_t m = 0u;
    const int8_t* b = rows + t * kBoard;
    if (t < nrows) {
      const int parent = filter ? (int)rsrc[c0 + t] : 0;
      m = slot_mask(b, die, parent, filter);
      if (mir) {  // scan order: bar, points 23..0, then the bear-offs
        m = (m & ~kPointsAndBar) | (__brev(m & kPointsAndBar) >> 7);
      }
    }
    int total;
    const int excl = block_scan(__popc(m), sm.warp_tot, total);
    const int keep = max(0, min(total, k_out - seen));
    if (keep > 0) {
      int i = excl;
      for (uint32_t mm = m; mm != 0u && i < keep; mm &= mm - 1u, ++i) {
        const int s = __ffs(mm) - 1;
        const int slot = (mir && s < 25) ? 24 - s : s;
        sm.items[i] = slot_item(b, t, slot, die);
      }
      __syncthreads();
      for (int i0 = hw; i0 < keep; i0 += kHalfWarps) {
        const uint32_t item = sm.items[i0];
        const int8_t* pb = rows + (item & 0xffu) * kBoard;
        const int o = (int8_t)(item >> 8), d = (int8_t)(item >> 16);
        const int h = (item >> 24) & 1;
        const size_t slot = (size_t)(seen + i0);
        if (hl < kWords) {
          uint32_t word = 0u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            word |= after_byte(pb, 4 * hl + q, o, d, h) << (8 * q);
          }
          reinterpret_cast<uint32_t*>(out + slot * kBoard)[hl] = word;
        } else if (hl == kWords) {
          rout[slot] = (int8_t)rank_of(o);
        }
      }
    }
    seen += total;
  }

  const int filled = min(seen, k_out);
  uint32_t* tail = reinterpret_cast<uint32_t*>(out) + (size_t)filled * kWords;
  for (int w = t; w < (k_out - filled) * kWords; w += kThreads) tail[w] = 0u;
  for (int e = filled + t; e < k_out; e += kThreads) rout[e] = 0;
  if (t == 0) n_out[g] = seen;
}

}  // namespace

// Pointers are device pointers; ranks and n_in are both null for a root
// level (no rank filter, all K rows valid).  boards_out must start on a 4-byte
// boundary.  Returns the CUDA error of the launch (0: launched).
extern "C" int doubles_level_launch(const void* boards, const void* ranks,
                                    const void* n_in, const void* dice,
                                    const void* mirror, void* boards_out,
                                    void* ranks_out, void* n_out, int games,
                                    int k, int k_out, void* stream) {
  if (games <= 0) return (int)cudaGetLastError();
  if (k < 0 || k_out < 0 || (uintptr_t)boards_out % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int words = (uintptr_t)boards % 4 == 0 ? 1 : 0;
  doubles_level_kernel<<<games, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)boards, (const int8_t*)ranks, (const int32_t*)n_in,
      (const int32_t*)dice, (const uint8_t*)mirror, (int8_t*)boards_out,
      (int8_t*)ranks_out, (int32_t*)n_out, k, k_out, words);
  return (int)cudaGetLastError();
}
