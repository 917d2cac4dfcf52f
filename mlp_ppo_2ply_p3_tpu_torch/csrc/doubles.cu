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
// levels must read each game's root and write the three frontiers with their
// zero tails: 53 bytes a row, 13.4 MB at B=4096 (`fast`, 875 games: 288 rows
// a game), 4 us at 3.35 TB/s.  At that size the 875 blocks are one wave of
// the 132 SMs, so what a launch costs is one block's chain of dependent
// steps.  What the design does about it:
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
//   with one bit reversal, and counts it with popc.  A block-wide exclusive scan of the counts gives each row its
//   first output slot; the running count carries across chunks.
// - Each landing candidate (output slot < k_out) is listed in shared memory
//   as (row, origin, dest, hit).  The block then writes the landing rows
//   word by word: thread x takes word x of the chunk's rows, so consecutive
//   threads store consecutive words of device memory; each word is the staged
//   parent's word plus the submove's byte deltas.  No candidate grid, valid mask or rank array ever
//   reaches device memory.  Zero tails go out in 16-byte stores.
// - The final form (one block of 128 threads per game) knows the game's L4
//   count when its loop ends: where it is 0 the block copies the chosen
//   earlier level's rows word by word instead, so the selection costs no pass
//   over the (G, M, 52) output.
//
// Nothing here allocates: the caller passes the outputs.

#include "board.cuh"

namespace {

constexpr int kThreads = 128;             // a block a game; rows of a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kRootWords = 16;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kMaxItems = kThreads * kSlots;

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

__global__ void __launch_bounds__(kThreads)
doubles_final_kernel(const int8_t* __restrict__ boards,
                     const int8_t* __restrict__ ranks,
                     const int32_t* __restrict__ n_in,
                     const int32_t* __restrict__ dice,
                     const uint8_t* __restrict__ mirror,
                     int8_t* __restrict__ boards_out,
                     int32_t* __restrict__ n_out, int k, int k_out,
                     int words, Earlier early) {
  __shared__ Smem sm;
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int hw = t >> 4, hl = t & 15;
  const int die = dice[g];
  const bool mir = mirror[g] != 0;
  const int nv = max(0, min(n_in[g], k));
  const int8_t* src = boards + (size_t)g * k * kBoard;
  const int8_t* rsrc = ranks + (size_t)g * k;
  int8_t* out = boards_out + (size_t)g * k_out * kBoard;

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
    Bits b;
    if (t < nrows) {
      b = row_bits(sm.rows + t * kWords);
      m = scan_order(slot_mask(b, die, (int)rsrc[c0 + t], true), mir);
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
        const size_t slot = (size_t)(seen + i0);
        if (hl < kWords) {
          reinterpret_cast<uint32_t*>(out + slot * kBoard)[hl] =
              after_word(sm.rows[(item & 0xffu) * kWords + hl], item, hl);
        }
      }
    }
    seen += total;
  }

  // the deepest non-empty level is the list
  uint32_t* out_w = reinterpret_cast<uint32_t*>(out);
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
  static int max_dyn = -1;  // the most dynamic shared memory a block gets
  if (games <= 0) return (int)cudaGetLastError();
  if (k1 < 0 || k2 < 0 || k3 < 0 ||
      (((uintptr_t)f1b | (uintptr_t)f2b | (uintptr_t)f3b) & 3) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (max_dyn < 0) {  // once, before any capture: the most the card allows
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
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
    max_dyn = most;
  }
  const size_t smem = (size_t)4 * levels_words(k1, k2, k3);
  if (smem > (size_t)max_dyn) return (int)cudaErrorInvalidValue;
  doubles_levels_kernel<<<games, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)vecs, (const int32_t*)dice, (const uint8_t*)mirror,
      (int8_t*)f1b, (int32_t*)n1, (int8_t*)f2b, (int32_t*)n2, (int8_t*)f3b,
      (int8_t*)f3r, (int32_t*)n3, k1, k2, k3);
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
  doubles_final_kernel<<<games, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)f3b, (const int8_t*)f3r, (const int32_t*)n3,
      (const int32_t*)dice, (const uint8_t*)mirror, (int8_t*)out,
      (int32_t*)n_out, k3, m, words, early);
  return (int)cudaGetLastError();
}
