// Movegen's doubles frontier for Hopper (sm_90a): one level per launch.  A
// level expands every frontier row by the die over the 27 submove slots, in
// the reference's scan order, keeps the expansions whose origin rank does not
// fall below the row's own, and stable-compacts them into the next frontier.
// The last level also writes the final move list.
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
// doubles_final_launch is the fourth level together with the selection
// after it, mlp_ppo_2ply_p3_tpu/core/movegen.py:420 (the L4 `level`) and
// :422-439 (the deepest non-empty level is the list).  From L3 (boards,
// ranks, n3) and the L1 and L2 frontiers with their unclamped counts, per
// game, with M = k_out:
//
//   -> out (G, M, 52): L4's candidates if n4 > 0, else the first min(K, M)
//      rows of L3 if n3 > 0, else of L2 if n2 > 0, else of L1, as they are
//      (rows past a level's count are the level's own), then zeros;
//      n (G,) int32: that level's count, clamped to M (even where it
//      exceeds the level's width K);
//      overflow (G,) uint8: (n2 > 0 & n2 > K2) | (n3 > 0 & n3 > K3) |
//      (n4 > M) | (n4 == 0 & n3 > M) | (n3 == 0 & n2 > M).
//
// The rules (slot predicate, afterstate, scan order) are board.cuh's.
//
// What bounds it on this card: bytes, and at movegen's sizes latency.  The
// function must read the valid frontier rows and write the next frontier:
// about 27 MB over the four levels of a `fast` movegen call at B=4096 (39 MB
// if every frontier row were read), 8 us at 3.35 TB/s; the final form adds
// the earlier level's rows of the few games whose L4 is empty.  The candidate
// grid it replaces, (G, K x 27, 53) before the compaction (240 MB at the last
// level), and the selection's three (G, M, 52) embeddings and `where`s are
// what cost the time.  What the design does about it:
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
// - The zero tail is written with 16-byte stores.  Rows at or past k_out are
//   counted and never written.
// - The final form knows the game's L4 count when its loop ends: where it is
//   0 the block copies the chosen earlier level's rows word by word instead,
//   so the selection costs no pass over the (G, M, 52) output.
//
// Nothing here allocates: the caller passes the outputs.

#include "board.cuh"

namespace {

constexpr int kThreads = 128;             // a block: rows of a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kMaxItems = kThreads * kSlots;

struct Smem {
  uint32_t rows[kThreads * kWords];  // the chunk's frontier rows
  uint32_t items[kMaxItems];         // the chunk's landing candidates
  int warp_tot[kWarps];
};

// The L1 and L2 frontiers that the final form falls back on.
struct Earlier {
  const int8_t* f1b;
  const int32_t* n1;
  int k1;
  const int8_t* f2b;
  const int32_t* n2;
  int k2;
  uint8_t* overflow;
};

// Copy `rows` rows of 52 bytes from src to the 4-byte aligned dst.
__device__ __forceinline__ void copy_rows(uint32_t* dst, const int8_t* src,
                                          int rows, int t) {
  if (((uintptr_t)src & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (int w = t; w < rows * kWords; w += kThreads) dst[w] = __ldg(s + w);
  } else {
    int8_t* d = reinterpret_cast<int8_t*>(dst);
    for (int e = t; e < rows * kBoard; e += kThreads) d[e] = src[e];
  }
}

template <bool kFinal>
__global__ void __launch_bounds__(kThreads)
doubles_level_kernel(const int8_t* __restrict__ boards,
                     const int8_t* __restrict__ ranks,
                     const int32_t* __restrict__ n_in,
                     const int32_t* __restrict__ dice,
                     const uint8_t* __restrict__ mirror,
                     int8_t* __restrict__ boards_out,
                     int8_t* __restrict__ ranks_out,
                     int32_t* __restrict__ n_out, int k, int k_out,
                     int words, Earlier early) {
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
  int8_t* rout = kFinal ? nullptr : ranks_out + (size_t)g * k_out;
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
      m = scan_order(slot_mask(b, die, parent, filter), mir);
    }
    int total;
    const int excl = block_scan<kWarps>(__popc(m), sm.warp_tot, total);
    const int keep = max(0, min(total, k_out - seen));
    if (keep > 0) {
      int i = excl;
      for (uint32_t mm = m; mm != 0u && i < keep; mm &= mm - 1u, ++i) {
        const int slot = scan_slot(__ffs(mm) - 1, mir);
        sm.items[i] = slot_item(b, t, slot, die);
      }
      __syncthreads();
      for (int i0 = hw; i0 < keep; i0 += kHalfWarps) {
        const uint32_t item = sm.items[i0];
        const int8_t* pb = rows + (item & 0xffu) * kBoard;
        const size_t slot = (size_t)(seen + i0);
        if (hl < kWords) {
          reinterpret_cast<uint32_t*>(out + slot * kBoard)[hl] =
              after_word(pb, item, hl);
        } else if (!kFinal && hl == kWords) {
          rout[slot] = (int8_t)rank_of((int8_t)(item >> 8));
        }
      }
    }
    seen += total;
  }

  uint32_t* out_w = reinterpret_cast<uint32_t*>(out);
  if (!kFinal) {
    const int filled = min(seen, k_out);
    zero_words(out_w + (size_t)filled * kWords,
               (long long)(k_out - filled) * kWords, t, kThreads);
    for (int e = filled + t; e < k_out; e += kThreads) rout[e] = 0;
    if (t == 0) n_out[g] = seen;
    return;
  }

  // the final form: the deepest non-empty level is the list
  const int n4 = seen;
  const int n3 = n_in[g], n2 = early.n2[g], n1 = early.n1[g];
  int filled = min(n4, k_out), n = filled;
  if (n4 == 0) {
    const int8_t* lsrc;
    int kl, nl;
    if (n3 > 0) {
      lsrc = src, kl = k, nl = n3;
    } else if (n2 > 0) {
      lsrc = early.f2b + (size_t)g * early.k2 * kBoard, kl = early.k2, nl = n2;
    } else {
      lsrc = early.f1b + (size_t)g * early.k1 * kBoard, kl = early.k1, nl = n1;
    }
    filled = min(kl, k_out);
    n = min(nl, k_out);
    copy_rows(out_w, lsrc, filled, t);
  }
  zero_words(out_w + (size_t)filled * kWords,
             (long long)(k_out - filled) * kWords, t, kThreads);
  if (t == 0) {
    n_out[g] = n;
    const bool has2 = n2 > 0, has3 = n3 > 0, has4 = n4 > 0;
    early.overflow[g] = (uint8_t)((has2 && n2 > early.k2) ||
                                  (has3 && n3 > k) || (has4 && n4 > k_out) ||
                                  (!has4 && has3 && n3 > k_out) ||
                                  (!has3 && has2 && n2 > k_out));
  }
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
  doubles_level_kernel<false><<<games, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)boards, (const int8_t*)ranks, (const int32_t*)n_in,
      (const int32_t*)dice, (const uint8_t*)mirror, (int8_t*)boards_out,
      (int8_t*)ranks_out, (int32_t*)n_out, k, k_out, words, Earlier{});
  return (int)cudaGetLastError();
}

// The fourth level and the final list: f3b (G, k3, 52), f3r (G, k3), n3
// (G,) as a level's inputs; f1b (G, k1, 52), f2b (G, k2, 52) and their
// unclamped counts n1, n2; out (G, m, 52) on a 4-byte boundary, n (G,)
// int32, overflow (G,) uint8.  Returns the CUDA error of the launch.
extern "C" int doubles_final_launch(const void* f1b, const void* n1, int k1,
                                    const void* f2b, const void* n2, int k2,
                                    const void* f3b, const void* f3r,
                                    const void* n3, int k3, const void* dice,
                                    const void* mirror, void* out,
                                    void* n_out, void* overflow, int games,
                                    int m, void* stream) {
  if (games <= 0) return (int)cudaGetLastError();
  if (k1 < 0 || k2 < 0 || k3 < 0 || m < 0 || (uintptr_t)out % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int words = (uintptr_t)f3b % 4 == 0 ? 1 : 0;
  const Earlier early{(const int8_t*)f1b, (const int32_t*)n1, k1,
                      (const int8_t*)f2b, (const int32_t*)n2, k2,
                      (uint8_t*)overflow};
  doubles_level_kernel<true><<<games, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)f3b, (const int8_t*)f3r, (const int32_t*)n3,
      (const int32_t*)dice, (const uint8_t*)mirror, (int8_t*)out, nullptr,
      (int32_t*)n_out, k3, m, words, early);
  return (int)cudaGetLastError();
}
