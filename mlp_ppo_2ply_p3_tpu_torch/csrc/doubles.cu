// Movegen's doubles frontier for Hopper (sm_90a): the first three levels in
// one launch, then the fourth level and the final move list in a second.  A
// level expands every frontier row by the die over the 27 submove slots, in
// the reference's scan order, keeps the expansions whose origin rank does not
// fall below the row's own, and stable-compacts them into the next frontier.
//
// doubles_levels_launch replaces the JAX package's `first` + compaction and
// two calls of its jnp `level`, mlp_ppo_2ply_p3_tpu/core/movegen.py:395-419
// (L1, L2 and L3; each compaction is the Pallas compact_rows,
// mlp_ppo_2ply_p3_tpu/ops/compaction.py:231, under use_pallas).  Per game g,
// with widths k1, k2, k3:
//
//   vecs (G, 52) int8 roots, die (G,) int32 in 0..6, mirror (G,) uint8/bool
//   -> f1b (G, k1, 52), f2b (G, k2, 52), f3b (G, k3, 52) int8: each level's
//      valid candidates in (frontier row, scan position) order, then zeros
//      (L1 from the root with no rank filter; L2 from L1's first min(n1,
//      k1) rows, L3 from L2's first min(n2, k2), each with the rank filter);
//      f3r (G, k3) int8: L3's origin ranks, then zeros; n1, n2, n3 (G,)
//      int32: the number of valid candidates of each level (may exceed its
//      width).
//
// doubles_final_launch is the fourth level together with the selection
// after it, mlp_ppo_2ply_p3_tpu/core/movegen.py:420 (the L4 `level`) and
// :422-439 (the deepest non-empty level is the list), and, in place, the
// doubles half of legal_afterstates_batch's gather back (:590-614).  From L3
// (boards, ranks, n3) and the L1 and L2 frontiers with their unclamped
// counts, per slot g of the sub-batch, with M = k_out:
//
//   -> a list of M rows: L4's candidates if n4 > 0, else the first min(K,
//      M) rows of L3 if n3 > 0, else of L2 if n2 > 0, else of L1, as they
//      are (rows past a level's count are the level's own), then zeros; at
//      row g of out (G, M, 52), or in place at row dst[g] of the batch's
//      out (B, M, 52), and nowhere where dst[g] is -1 (an empty slot);
//      n (G,) int32: that level's count, clamped to M (even where it
//      exceeds the level's width K), 0 at an empty slot;
//      overflow (G,) uint8: (n2 > 0 & n2 > K2) | (n3 > 0 & n3 > K3) |
//      (n4 > M) | (n4 == 0 & n3 > M) | (n3 == 0 & n2 > M), 0 at an empty
//      slot.
//
// The rules (slot predicate, afterstate, scan order) are board.cuh's.
//
// What bounds them on this card: bytes, and at movegen's sizes latency.
// The levels must read each game's root and write the three frontiers with
// their zero tails: 53 bytes a row, 13.4 MB at B=4096 (`fast`, 875 games:
// 288 rows a game), 4 us at 3.35 TB/s.  At that size the 875 blocks are one
// wave of the 132 SMs, so what a launch costs is one block's chain of
// dependent steps.  What the design does about it:
//
// - One block of 128 threads per game runs L1, L2 and L3 (48 registers, no
//   spills: 10 blocks an SM, so B=4096's 875 games are one wave).  L1 and L2
//   stay in shared memory as the next level's input, (min(k1, 27) + k2) x 53
//   bytes with the landing list, 5.9 KB at `fast`; each frontier is also
//   written to device memory once, L1 and L2 for the final level's fallback
//   and L3 with its ranks as its input.  One launch in place of three: no
//   frontier is read back from device memory, and two launches and their
//   tails go.
// - Within a level, one thread per frontier row (128 rows a chunk) reads the
//   row's 13 words, builds its bit sets and from them the row's 27-bit mask
//   of valid, rank-filtered slots (board.cuh), permutes it into scan order
//   with one bit reversal, and counts it with popc.  A block-wide exclusive
//   scan of the counts gives each row its first output slot; the running
//   count carries across chunks.
// - Each landing candidate (output slot < k_out) is listed in shared memory
//   as (row, origin, dest, hit).  The block then writes the landing rows
//   word by word: thread x takes word x of the chunk's rows, so consecutive
//   threads store consecutive words of device memory; each word is the
//   staged parent's word plus the submove's byte deltas.  No candidate grid,
//   valid mask or rank array ever reaches device memory.  Zero tails go out
//   in 16-byte stores.
//
// The final form in place must read each listed slot's valid L3 rows and
// ranks (53 bytes a row; about 26 rows a game on played boards), its counts,
// die and mirror flag and, where L4 is empty, the rows of the level that
// stands in, and write the slot's M rows of the batch's list with its count
// and flag: about 9.5 MB at B=4096 (`fast`, about 680 of the 875 slots
// filled), 2.8 us at 3.35 TB/s.  The list goes where the batch keeps it, so
// no (G, M, 52) doubles list is written and copied again, and an empty slot
// writes its count and flag alone.  Again one block's chain sets the time:
//
// - One block of 256 threads a slot, one L3 row a thread, so that k3 <= 256
//   (every preset but parity's 512) takes one block scan and no chunk loop.
//   The slot's scalars (its row, counts, die, mirror flag) are loaded at
//   once, and each thread's rank with the rows, which go to shared memory
//   in 16-byte loads: two round trips to memory before the rules run.
// - 40 registers (__launch_bounds__(256, 6): 8 bytes spill), 6 blocks an
//   SM, so 792 slots run at once and B=4096's 875 slots, a fifth of them
//   empty, are about one wave (the register and spill figures are ptxas's
//   report, which chip_smoke.py prints with the build).  One shape serves
//   every list width; an L3 of more than 256 rows (parity's) takes two
//   chunks.
// - Shared memory holds one chunk of L3 rows and the items of the
//   candidates that land, sized to what can land: 13 min(k3, 256) +
//   min(M, 27 min(k3, 256)) words, 11 KB at `fast` and at most 40 KB at any
//   widths, beside 1 KB of static (each row's slot mask).
// - The items are built one thread a candidate: a row's thread lists
//   (row, rank among the row's valid slots) for each of its candidates,
//   then candidate i's thread finds its slot (the rank-th set bit of the
//   row's mask) and builds (row, origin, dest, hit), so no thread walks its
//   row's slots one item at a time.
// - The rows go out word by word as the levels' do; the zero tail in
//   16-byte stores as soon as L4's count is known; where L4 is empty the
//   chosen earlier level's first min(K, M) rows are copied, 16 bytes a load
//   and a store where both addresses allow it.
//
// Nothing here allocates: the caller passes the outputs.

#include "board.cuh"

namespace {

constexpr int kThreads = 128;             // a block a game; rows of a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kRootWords = 16;
// The final form: a block of 256 threads a slot, one L3 row a thread, and
// registers capped so that 6 blocks share an SM.
constexpr int kFinalThreads = 256;
constexpr int kFinalWarps = kFinalThreads / 32;
constexpr int kFinalBlocksPerSm = 6;

// The L1 rows shared memory holds: a root has at most 26 valid slots.
__host__ __device__ inline int l1_rows(int k1) { return min(k1, kSlots); }

// Words of dynamic shared memory of the fused levels: the root, the L1 and
// L2 frontiers (rows, then their ranks as bytes), and the landing
// candidates of a chunk (at most a level's width).
__host__ __device__ inline int levels_words(int k1, int k2, int k3) {
  const int r1 = l1_rows(k1);
  return kRootWords + (r1 + k2) * kWords + (r1 + k2 + 3) / 4 +
         max(r1, max(k2, k3));
}

// One level of one game, block-wide: expands the nc rows of the frontier fr
// (shared memory, 13 words a row; their parent ranks frk, or none and no rank
// filter) by the die and writes the first k_out candidates, in (row, scan
// position) order, to gout (device memory, k_out rows, zeros past the count)
// and their ranks to granks (device memory, zeros past the count), and both
// to sout and sranks (shared memory); each of the four may be null.  Returns
// the number of valid candidates, unclamped.
__device__ int expand_level(const uint32_t* fr, const int8_t* frk, int nc,
                            int die, bool mir, int k_out, uint32_t* items,
                            int* warp_tot, uint32_t* gout, int8_t* granks,
                            uint32_t* sout, int8_t* sranks) {
  const int t = threadIdx.x;
  int seen = 0;  // valid candidates of the earlier chunks
  for (int c0 = 0; c0 < nc; c0 += kThreads) {
    const int r = c0 + t;
    Bits b;
    uint32_t m = 0u;
    if (r < nc) {
      b = row_bits(fr + (size_t)r * kWords);
      m = scan_order(slot_mask(b, die, frk ? (int)frk[r] : 0, frk != nullptr),
                     mir);
    }
    int total;
    const int excl = block_scan<kWarps>(__popc(m), warp_tot, total);
    const int keep = max(0, min(total, k_out - seen));
    if (keep > 0) {
      int i = excl;
      for (uint32_t mm = m; mm != 0u && i < keep; mm &= mm - 1u, ++i) {
        items[i] = slot_item(b, t, scan_slot(__ffs(mm) - 1, mir), die);
      }
      __syncthreads();
      for (int x = t; x < keep * kWords; x += kThreads) {
        const int li = x / kWords, w = x - li * kWords;
        const uint32_t item = items[li];
        const uint32_t word = after_word(
            fr[(size_t)(c0 + (int)(item & 0xffu)) * kWords + w], item, w);
        const size_t slot = (size_t)(seen + li);
        if (gout) gout[slot * kWords + w] = word;
        if (sout) sout[slot * kWords + w] = word;
      }
      for (int li = t; li < keep; li += kThreads) {
        const int8_t rk = (int8_t)rank_of((int8_t)(items[li] >> 8));
        if (granks) granks[seen + li] = rk;
        if (sranks) sranks[seen + li] = rk;
      }
    }
    __syncthreads();  // items and warp_tot are free again
    seen += total;
  }
  const int filled = min(seen, k_out);
  if (gout) {
    zero_words(gout + (size_t)filled * kWords,
               (long long)(k_out - filled) * kWords, t, kThreads);
  }
  if (granks) {
    for (int e = filled + t; e < k_out; e += kThreads) granks[e] = 0;
  }
  return seen;
}

__global__ void __launch_bounds__(kThreads)
doubles_levels_kernel(const int8_t* __restrict__ vecs,
                      const int32_t* __restrict__ dice,
                      const uint8_t* __restrict__ mirror,
                      int8_t* __restrict__ f1b, int32_t* __restrict__ n1,
                      int8_t* __restrict__ f2b, int32_t* __restrict__ n2,
                      int8_t* __restrict__ f3b, int8_t* __restrict__ f3r,
                      int32_t* __restrict__ n3, int k1, int k2, int k3) {
  extern __shared__ __align__(16) uint32_t dyn[];
  __shared__ int warp_tot[kWarps];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int r1 = l1_rows(k1);
  uint32_t* root = dyn;
  uint32_t* l1 = root + kRootWords;
  uint32_t* l2 = l1 + (size_t)r1 * kWords;
  int8_t* l1r = reinterpret_cast<int8_t*>(l2 + (size_t)k2 * kWords);
  int8_t* l2r = l1r + r1;
  uint32_t* items = l2 + (size_t)k2 * kWords + (r1 + k2 + 3) / 4;
  const int die = dice[g];
  const bool mir = mirror[g] != 0;

  const int8_t* vg = vecs + (size_t)g * kBoard;
  if (((uintptr_t)vg & 3) == 0) {
    if (t < kWords) root[t] = __ldg(reinterpret_cast<const uint32_t*>(vg) + t);
  } else if (t < kBoard) {
    reinterpret_cast<int8_t*>(root)[t] = vg[t];
  }
  __syncthreads();

  uint32_t* o1 = reinterpret_cast<uint32_t*>(f1b + (size_t)g * k1 * kBoard);
  uint32_t* o2 = reinterpret_cast<uint32_t*>(f2b + (size_t)g * k2 * kBoard);
  uint32_t* o3 = reinterpret_cast<uint32_t*>(f3b + (size_t)g * k3 * kBoard);
  // L1 from the root (at most 26 valid slots: r1 rows hold them all)
  const int c1 = expand_level(root, nullptr, 1, die, mir, k1, items,
                              warp_tot, o1, nullptr, l1, l1r);
  const int c2 = expand_level(l1, l1r, min(c1, k1), die, mir, k2, items,
                              warp_tot, o2, nullptr, l2, l2r);
  const int c3 = expand_level(l2, l2r, min(c2, k2), die, mir, k3, items,
                              warp_tot, o3, f3r + (size_t)g * k3, nullptr,
                              nullptr);
  if (t == 0) {
    n1[g] = c1;
    n2[g] = c2;
    n3[g] = c3;
  }
}

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

// Words of dynamic shared memory of the final form: one chunk of L3 rows (a
// row a thread), and the items of the candidates that land from it (at most
// M, at most 27 a row).
__host__ __device__ inline int final_words(int k3, int m) {
  const int rows = min(k3, kFinalThreads);
  return rows * kWords + min(m, rows * kSlots);
}

// Copy nbytes (a multiple of 4) from src to the 4-byte aligned dst; threads
// t of n share the work: 16 bytes a load and a store where both addresses
// allow it, else 4 (src on a 4-byte boundary) or 1.
__device__ __forceinline__ void copy_bytes(uint32_t* dst, const int8_t* src,
                                           int nbytes, int t, int n) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int nv = nbytes / 16;
    for (int i = t; i < nv; i += n) d[i] = __ldg(s + i);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(src);
    for (int w = 4 * nv + t; w < nbytes / 4; w += n) dst[w] = __ldg(sw + w);
  } else if (((uintptr_t)src & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (int w = t; w < nbytes / 4; w += n) dst[w] = __ldg(s + w);
  } else {
    int8_t* d = reinterpret_cast<int8_t*>(dst);
    for (int e = t; e < nbytes; e += n) d[e] = src[e];
  }
}

// The position of the j-th (from 0) set bit of x, j < popc(x): five halvings.
__device__ __forceinline__ int nth_bit(uint32_t x, int j) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(x & ((1u << w) - 1u));
    if (j >= c) {
      j -= c;
      x >>= w;
      pos += w;
    }
  }
  return pos;
}

// The rows of a game's list before its zero tail: L4's (clamped to M), or,
// where L4 is empty, the width of the level that stands in (clamped to M).
__device__ __forceinline__ int list_rows(int n4, int n3, int n2, int k3,
                                         int k2, int k1, int k_out) {
  if (n4 > 0) return min(n4, k_out);
  return min(n3 > 0 ? k3 : (n2 > 0 ? k2 : k1), k_out);
}

__global__ void __launch_bounds__(kFinalThreads, kFinalBlocksPerSm)
doubles_final_kernel(const int8_t* __restrict__ boards,
                     const int8_t* __restrict__ ranks,
                     const int32_t* __restrict__ n_in,
                     const int32_t* __restrict__ dice,
                     const uint8_t* __restrict__ mirror,
                     const int32_t* __restrict__ dst,
                     int8_t* __restrict__ boards_out, int rows_out,
                     int32_t* __restrict__ n_out, int k, int k_out,
                     Earlier early) {
  extern __shared__ __align__(16) uint32_t dyn[];
  __shared__ int warp_tot[kFinalWarps];
  __shared__ uint32_t masks[kFinalThreads];  // each row's valid slots
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  // every scalar of the slot at once: one round trip
  const int row = dst ? dst[g] : g;
  const int die = dice[g];
  const bool mir = mirror[g] != 0;
  const int n3 = n_in[g], n2 = early.n2[g], n1 = early.n1[g];
  // a row outside out fails the launch (a sticky error, as torch's device
  // asserts on an index out of range), never a write past out's end
  if (row < -1 || row >= rows_out) __trap();
  if (row < 0) {  // an empty slot of the sub-batch: no list
    if (t == 0) {
      n_out[g] = 0;
      early.overflow[g] = 0;
    }
    return;
  }
  uint32_t* rows = dyn;                                   // a chunk of L3
  uint32_t* items = dyn + (size_t)min(k, kFinalThreads) * kWords;
  const int nv = max(0, min(n3, k));
  const int8_t* src = boards + (size_t)g * k * kBoard;
  const int8_t* rsrc = ranks + (size_t)g * k;
  uint32_t* out =
      reinterpret_cast<uint32_t*>(boards_out + (size_t)row * k_out * kBoard);

  int seen = 0;     // valid candidates of the earlier chunks
  int filled = -1;  // the list's rows before its zero tail, once known
  for (int c0 = 0; c0 < nv; c0 += kFinalThreads) {
    const int nrows = min(kFinalThreads, nv - c0);
    const int rank = t < nrows ? (int)rsrc[c0 + t] : 0;  // with the rows
    if (c0 > 0) __syncthreads();  // the last chunk's writers are done
    copy_bytes(rows, src + (size_t)c0 * kBoard, nrows * kBoard, t,
               kFinalThreads);
    __syncthreads();

    const uint32_t m =
        t < nrows ? scan_order(slot_mask(row_bits(rows + t * kWords), die,
                                         rank, true), mir)
                  : 0u;
    int total;
    const int excl = block_scan<kFinalWarps>(__popc(m), warp_tot, total);
    const int keep = max(0, min(total, k_out - seen));
    if (c0 + kFinalThreads >= nv) {  // the last chunk: L4's count is known
      filled = list_rows(seen + total, n3, n2, k, early.k2, early.k1, k_out);
      zero_words(out + (size_t)filled * kWords,
                 (long long)(k_out - filled) * kWords, t, kFinalThreads);
    }
    if (keep > 0) {
      // each landing candidate's row and its rank among the row's valid
      // slots, then its item, one thread a candidate
      masks[t] = m;
      for (int i = excl, j = 0; i < min(excl + __popc(m), keep); ++i, ++j) {
        items[i] = (uint32_t)t | ((uint32_t)j << 8);
      }
      __syncthreads();
      for (int i = t; i < keep; i += kFinalThreads) {
        const int r = (int)(items[i] & 0xffu), j = (int)(items[i] >> 8);
        items[i] = slot_item(row_bits(rows + r * kWords), r,
                             scan_slot(nth_bit(masks[r], j), mir), die);
      }
      __syncthreads();
      uint32_t* o = out + (size_t)seen * kWords;
      for (int x = t; x < keep * kWords; x += kFinalThreads) {
        const int li = x / kWords, w = x - li * kWords;
        const uint32_t item = items[li];
        o[x] = after_word(rows[(item & 0xffu) * kWords + w], item, w);
      }
    }
    seen += total;
  }

  // the deepest non-empty level is the list
  const int n4 = seen;
  if (filled < 0) {  // no L3 row: L4 is empty
    filled = list_rows(0, n3, n2, k, early.k2, early.k1, k_out);
    zero_words(out + (size_t)filled * kWords,
               (long long)(k_out - filled) * kWords, t, kFinalThreads);
  }
  int n = min(n4, k_out);
  if (n4 == 0) {
    const int8_t* lsrc;
    int nl;
    if (n3 > 0) {
      lsrc = src, nl = n3;
    } else if (n2 > 0) {
      lsrc = early.f2b + (size_t)g * early.k2 * kBoard, nl = n2;
    } else {
      lsrc = early.f1b + (size_t)g * early.k1 * kBoard, nl = n1;
    }
    n = min(nl, k_out);
    copy_bytes(out, lsrc, filled * kBoard, t, kFinalThreads);
  }
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

// The first three levels: vecs (G, 52), die (G,) int32, mirror (G,) uint8;
// f1b (G, k1, 52), f2b (G, k2, 52), f3b (G, k3, 52) on 4-byte boundaries,
// f3r (G, k3), n1, n2, n3 (G,) int32.  Pointers are device pointers.
// Returns the CUDA error of the launch (0: launched); cudaErrorInvalidValue
// where the widths need more shared memory than a block may have.
extern "C" int doubles_levels_launch(const void* vecs, const void* dice,
                                     const void* mirror, void* f1b, void* n1,
                                     void* f2b, void* n2, void* f3b,
                                     void* f3r, void* n3, int games, int k1,
                                     int k2, int k3, void* stream) {
  // the most dynamic shared memory a block gets, for each card apart (the
  // opt-in is the current card's); 0: not set yet
  static int max_dyn[kMaxDevices] = {};
  if (games <= 0) return (int)cudaGetLastError();
  if (k1 < 0 || k2 < 0 || k3 < 0 ||
      (((uintptr_t)f1b | (uintptr_t)f2b | (uintptr_t)f3b) & 3) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return (int)cudaErrorInvalidDevice;
  }
  if (max_dyn[dev] == 0) {  // once a card, before any capture: its most
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaFuncGetAttributes(&attr, doubles_levels_kernel);
    }
    const int most = optin - (int)attr.sharedSizeBytes;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(doubles_levels_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    }
    if (err != cudaSuccess) return (int)err;
    max_dyn[dev] = most;
  }
  const size_t smem = (size_t)4 * levels_words(k1, k2, k3);
  if (smem > (size_t)max_dyn[dev]) return (int)cudaErrorInvalidValue;
  doubles_levels_kernel<<<games, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)vecs, (const int32_t*)dice, (const uint8_t*)mirror,
      (int8_t*)f1b, (int32_t*)n1, (int8_t*)f2b, (int32_t*)n2, (int8_t*)f3b,
      (int8_t*)f3r, (int32_t*)n3, k1, k2, k3);
  return (int)cudaGetLastError();
}

// The fourth level and the final list: f3b (G, k3, 52), f3r (G, k3), n3
// (G,) as a level's inputs; f1b (G, k1, 52), f2b (G, k2, 52) and their
// unclamped counts n1, n2; n (G,) int32, overflow (G,) uint8.  dst null:
// out (G, m, 52), slot g's list at row g.  dst (G,) int32: slot g's list at
// row dst[g] of out (rows_out, m, 52), none where dst[g] is -1 (n and
// overflow 0 there); the rows of dst must differ, and one outside [-1,
// rows_out) traps in the kernel.  out on a 4-byte boundary.  Returns the
// CUDA error of the launch.  The shared memory (final_words) is at most 40
// KB at any widths: no opt-in.
extern "C" int doubles_final_launch(const void* f1b, const void* n1, int k1,
                                    const void* f2b, const void* n2, int k2,
                                    const void* f3b, const void* f3r,
                                    const void* n3, int k3, const void* dice,
                                    const void* mirror, const void* dst,
                                    void* out, int rows_out, void* n_out,
                                    void* overflow, int games, int m,
                                    void* stream) {
  if (games <= 0) return (int)cudaGetLastError();
  if (k1 < 0 || k2 < 0 || k3 < 0 || m < 0 || rows_out < 0 ||
      (uintptr_t)out % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Earlier early{(const int8_t*)f1b, (const int32_t*)n1, k1,
                      (const int8_t*)f2b, (const int32_t*)n2, k2,
                      (uint8_t*)overflow};
  const size_t smem = (size_t)4 * final_words(k3, m);
  doubles_final_kernel<<<games, kFinalThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)f3b, (const int8_t*)f3r, (const int32_t*)n3,
      (const int32_t*)dice, (const uint8_t*)mirror, (const int32_t*)dst,
      (int8_t*)out, rows_out, (int32_t*)n_out, k3, m, early);
  return (int)cudaGetLastError();
}
