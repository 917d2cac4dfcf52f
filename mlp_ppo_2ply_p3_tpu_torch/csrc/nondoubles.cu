// Movegen's non-doubles batch for Hopper (sm_90a): every legal afterstate of
// a non-double roll, one launch for all games.
//
// nondoubles_launch replaces the JAX package's `_nondoubles_candidates` and
// `_nondoubles_batch`, mlp_ppo_2ply_p3_tpu/core/movegen.py:301-369: both die
// orders (`_one_order`, :286-298), the emission and max-submove rules
// (:311-343), the raw compaction, the first-occurrence dedup
// (`_dedup_pairwise`, :256-273) and the compaction into the list (:354-367),
// which XLA fused around the Pallas compact_rows
// (mlp_ppo_2ply_p3_tpu/ops/compaction.py:231) under use_pallas.  Per game g:
//
//   vecs (G, 52) int8, d_hi and d_lo (G,) int32 in 0..6, mirror (G,)
//   uint8/bool; widths k1 >= 1, kd, M; dedup
//   -> out (G, M, 52) int8, n (G,) int32 clamped to M, overflow (G,) uint8
//
//   1. Per die order, A = (d_hi, d_lo) then B = (d_lo, d_hi): the first
//      die's valid slots in scan order, the first k1 of them kept as
//      singles; each single expanded by the second die over the 27 slots, in
//      (single, scan position) order; has2 = any valid pair.
//   2. Emission, in block order [A pairs, A singles, B pairs, B singles]: an
//      order's singles only where it has no pair; B only unless A has no
//      pair and exactly one single.
//   3. Max-submove filter: the pairs if any is emitted, else the singles.
//   4. dedup: the first kd of those raw candidates, the first occurrence of
//      each packed key (core/board.py::pack_key: the low 4 bits of every
//      count), the first M of them; n = min(unique, M), overflow =
//      (raw > kd) | (unique > M).  No dedup: the first M raw candidates,
//      n = min(raw, M), overflow = raw > M.
//
// The rules (slot predicate, afterstate, scan order) are board.cuh's.
//
// What bounds it on this card: bytes.  The function must read 61 bytes a game
// and write the (G, M, 52) list, zeros included: 48 MB at B=4096 (`fast`,
// 3604 games), 14 us at 3.35 TB/s.  The jnp path it replaces wrote the
// stacked first-die grid, the (2G, k1 x 27, 52) second-die grid and the
// (G, 2 (k1 x 27 + k1), 52) candidate block to device memory before
// compacting and deduplicating: about 160 MB a call at that size.  What the
// design does about it:
//
// - One block per game; the board and dice go to registers and shared
//   memory.  Two threads build the two orders' first-die masks (27 bits,
//   permuted into scan order by one bit reversal, counted with popc), and
//   half-warps build the kept singles into shared memory (at most 2 x 32
//   rows).
// - Warp o holds order o, lane i its single i: each lane builds its second-
//   die mask, and a warp scan of the popcounts gives every pair its rank
//   within the order.  has2, the B-skip and the max-submove filter follow
//   from the counts alone, before any row is built, so each candidate knows
//   its raw rank and only those below kd (M without dedup) are listed, as
//   (single, origin, dest, hit).
// - Half-warps build one listed row each, lane l word l, straight into the
//   output without dedup; with dedup into shared memory, where the packed
//   keys are made.  One warp checks one row's predecessors, 32 at a time,
//   and stops at the first equal key; a block scan of the survivors gives
//   their ranks, and half-warps copy the first M out, 13 lanes a row.
// - The zero tail goes out in 16-byte stores.  No candidate grid, raw block
//   or (K, K) block reaches device memory.
//
// Nothing here allocates: the caller passes the outputs.

#include "board.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kMaxSingles = 32;   // one die's valid slots: at most 26
constexpr int kKeyWords = 7;

struct Static {
  uint32_t root[kWords];
  uint32_t singles[2 * kMaxSingles * kWords];  // [order][single] rows
  uint32_t first_mask[2];
  int n_single[2];                             // min(first-die slots, k1)
  int pairs[2];
  int warp_tot[kWarps];
};

// Dynamic shared memory for `limit` listed candidates: their items, and with
// dedup their rows, packed keys and the survivors' row indices.
__host__ __device__ inline size_t dyn_bytes(int limit, bool dedup) {
  return (size_t)limit * (4 + (dedup ? kBoard + 4 * kKeyWords + 2 : 0));
}

__global__ void __launch_bounds__(kThreads)
nondoubles_kernel(const int8_t* __restrict__ vecs,
                  const int32_t* __restrict__ d_hi,
                  const int32_t* __restrict__ d_lo,
                  const uint8_t* __restrict__ mirror,
                  int8_t* __restrict__ out, int32_t* __restrict__ n_out,
                  uint8_t* __restrict__ overflow, int k1, int kd, int m,
                  int dedup, int vec_words) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Static st;
  const int g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int hw = t >> 4, hl = t & 15;
  const bool mir = mirror[g] != 0;
  const int dh = d_hi[g], dl = d_lo[g];
  const int limit = dedup ? kd : m;
  uint32_t* items = reinterpret_cast<uint32_t*>(dyn);
  uint32_t* rows = items + limit;
  uint32_t* keys = rows + (size_t)limit * kWords;
  uint16_t* uidx = reinterpret_cast<uint16_t*>(keys + (size_t)kKeyWords * limit);
  const int8_t* root = reinterpret_cast<const int8_t*>(st.root);
  const int8_t* singles = reinterpret_cast<const int8_t*>(st.singles);

  // 1. the board
  const int8_t* vg = vecs + (size_t)g * kBoard;
  if (vec_words) {
    if (t < kWords) st.root[t] = __ldg(reinterpret_cast<const uint32_t*>(vg) + t);
  } else if (t < kBoard) {
    reinterpret_cast<int8_t*>(st.root)[t] = vg[t];
  }
  __syncthreads();

  // 2. each order's first die, in scan order
  if (t < 2) {
    const uint32_t m1 = scan_order(slot_mask(root, t == 0 ? dh : dl, 0, false),
                                   mir);
    st.first_mask[t] = m1;
    st.n_single[t] = min(__popc(m1), k1);
  }
  __syncthreads();

  // 3. the kept singles, a half-warp a row: single q = 32 o + i is the i-th
  //    valid first-die slot of order o
  for (int q = hw; q < 2 * kMaxSingles; q += kHalfWarps) {
    const int o = q / kMaxSingles, i = q % kMaxSingles;
    if (i >= st.n_single[o]) continue;
    uint32_t mm = st.first_mask[o];
    for (int j = 0; j < i; ++j) mm &= mm - 1u;
    const uint32_t item = slot_item(root, q, scan_slot(__ffs(mm) - 1, mir),
                                    o == 0 ? dh : dl);
    if (hl < kWords) st.singles[q * kWords + hl] = after_word(root, item, hl);
  }
  __syncthreads();

  // 4. the second die: warp o is order o, lane i its single i
  const int o = warp;
  const int q = o * kMaxSingles + lane;
  const int d2 = o == 0 ? dl : dh;
  uint32_t m2 = 0u;
  int excl = 0;
  if (warp < 2) {
    if (lane < st.n_single[o]) {
      m2 = scan_order(slot_mask(singles + q * kBoard, d2, 0, false), mir);
    }
    const int c = __popc(m2);
    int x = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    excl = x - c;
    if (lane == 31) st.pairs[o] = x;
  }
  __syncthreads();

  // 5. emission and the max-submove filter, from the counts alone
  const int sa = st.n_single[0], sb = st.n_single[1];
  const int pa = st.pairs[0], pb = st.pairs[1];
  const bool run_b = !(pa == 0 && sa == 1);
  const bool any_pair = pa > 0 || (pb > 0 && run_b);
  // the segments' counts, in block order
  const int cnt_ap = pa;
  const int cnt_as = any_pair ? 0 : sa;
  const int cnt_bp = run_b ? pb : 0;
  const int cnt_bs = (any_pair || !run_b) ? 0 : sb;
  const int off_as = cnt_ap, off_bp = off_as + cnt_as, off_bs = off_bp + cnt_bp;
  const int n_raw = off_bs + cnt_bs;
  const int n_list = min(n_raw, limit);

  // 6. list the candidates whose raw rank is below the limit
  if (warp < 2) {
    if (o == 0 ? cnt_ap > 0 : cnt_bp > 0) {
      const int8_t* sbd = singles + q * kBoard;
      int r = (o == 0 ? 0 : off_bp) + excl;
      for (uint32_t mm = m2; mm != 0u && r < limit; mm &= mm - 1u, ++r) {
        items[r] = slot_item(sbd, q, scan_slot(__ffs(mm) - 1, mir), d2);
      }
    }
    const int r = (o == 0 ? off_as : off_bs) + lane;
    if ((o == 0 ? cnt_as : cnt_bs) > lane && r < limit) {
      items[r] = identity_item(q);
    }
  }
  __syncthreads();

  uint32_t* ow = reinterpret_cast<uint32_t*>(out + (size_t)g * m * kBoard);
  int written, count;
  bool over;
  if (!dedup) {
    // 7. the raw candidates straight into the list
    for (int r = hw; r < n_list; r += kHalfWarps) {
      const uint32_t item = items[r];
      if (hl < kWords) {
        ow[(size_t)r * kWords + hl] =
            after_word(singles + (item & 0xffu) * kBoard, item, hl);
      }
    }
    written = n_list;
    count = n_raw;
    over = n_raw > m;
  } else {
    // 7. the listed rows into shared memory, then their packed keys
    for (int r = hw; r < n_list; r += kHalfWarps) {
      const uint32_t item = items[r];
      if (hl < kWords) {
        rows[r * kWords + hl] =
            after_word(singles + (item & 0xffu) * kBoard, item, hl);
      }
    }
    __syncthreads();
    for (int r = t; r < n_list; r += kThreads) {
      const uint8_t* b = reinterpret_cast<const uint8_t*>(rows + r * kWords);
#pragma unroll
      for (int w = 0; w < 6; ++w) {  // points: 4 (mine | opp << 4) bytes each
        uint32_t word = 0u;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const int p = 4 * w + qq;
          word |= (uint32_t)((b[p] & 0xF) | ((b[24 + p] & 0xF) << 4))
                  << (8 * qq);
        }
        keys[w * limit + r] = word;
      }
      keys[6 * limit + r] = (uint32_t)(b[48] & 0xF) |
                            ((uint32_t)(b[49] & 0xF) << 8) |
                            ((uint32_t)(b[50] & 0xF) << 16) |
                            ((uint32_t)(b[51] & 0xF) << 24);
    }
    __syncthreads();

    // 8. first occurrence: one warp a row, 32 predecessors at a time,
    //    stopping at the first equal key; the flag goes where its item was
    for (int j = warp; j < n_list; j += kWarps) {
      uint32_t kj[kKeyWords];
#pragma unroll
      for (int w = 0; w < kKeyWords; ++w) kj[w] = keys[w * limit + j];
      bool dup = false;
      for (int c0 = 0; c0 < j && !dup; c0 += 32) {
        const int jp = c0 + lane;
        bool eq = jp < j;
#pragma unroll
        for (int w = 0; w < kKeyWords; ++w) {
          eq = eq && keys[w * limit + jp] == kj[w];
        }
        dup = __any_sync(0xffffffffu, eq);
      }
      if (lane == 0) items[j] = dup ? 0u : 1u;
    }
    __syncthreads();

    // 9. the survivors' ranks
    int uniq = 0;
    for (int j0 = 0; j0 < n_list; j0 += kThreads) {
      const int j = j0 + t;
      const int f = j < n_list ? (int)items[j] : 0;
      int total;
      const int u = uniq + block_scan<kWarps>(f, st.warp_tot, total);
      if (f && u < m) uidx[u] = (uint16_t)j;
      uniq += total;
      __syncthreads();
    }

    // 10. the first M survivors into the list, a half-warp a row
    written = min(uniq, m);
    for (int u = hw; u < written; u += kHalfWarps) {
      if (hl < kWords) {
        ow[(size_t)u * kWords + hl] = rows[uidx[u] * kWords + hl];
      }
    }
    count = uniq;
    over = n_raw > kd || uniq > m;
  }
  zero_words(ow + (size_t)written * kWords,
             (long long)(m - written) * kWords, t, kThreads);
  if (t == 0) {
    n_out[g] = min(count, m);
    overflow[g] = over ? 1 : 0;
  }
}

}  // namespace

// Pointers are device pointers; out (G, m, 52) must start on a 4-byte
// boundary.  Returns the CUDA error of the launch (0: launched);
// cudaErrorInvalidValue where the widths need more shared memory than a
// block may have.
extern "C" int nondoubles_launch(const void* vecs, const void* d_hi,
                                 const void* d_lo, const void* mirror,
                                 void* out, void* n_out, void* overflow,
                                 int games, int k1, int kd, int m, int dedup,
                                 void* stream) {
  static int max_dyn = -1;  // the most dynamic shared memory a block gets
  if (games <= 0) return (int)cudaGetLastError();
  const int limit = dedup ? kd : m;
  if (k1 < 1 || kd < 0 || m < 0 || limit > 65535 ||
      (uintptr_t)out % 4 != 0) {
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
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, nondoubles_kernel);
    const int most = optin - (int)attr.sharedSizeBytes;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(nondoubles_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    }
    if (err != cudaSuccess) return (int)err;
    max_dyn = most;
  }
  const size_t smem = dyn_bytes(limit, dedup != 0);
  if (smem > (size_t)max_dyn) return (int)cudaErrorInvalidValue;
  const int words = (uintptr_t)vecs % 4 == 0 ? 1 : 0;
  nondoubles_kernel<<<games, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)vecs, (const int32_t*)d_hi, (const int32_t*)d_lo,
      (const uint8_t*)mirror, (int8_t*)out, (int32_t*)n_out,
      (uint8_t*)overflow, k1, kd, m, dedup, words);
  return (int)cudaGetLastError();
}
