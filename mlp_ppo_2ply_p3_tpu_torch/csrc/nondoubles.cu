// Movegen's non-doubles batch for Hopper (sm_90a): every legal afterstate of
// a non-double roll, one launch for all games, written where the batch's
// caller wants each game's list.
//
// nondoubles_launch replaces the JAX package's `_nondoubles_candidates` and
// `_nondoubles_batch`, mlp_ppo_2ply_p3_tpu/core/movegen.py:301-369: both die
// orders (`_one_order`, :286-298), the emission and max-submove rules
// (:311-343), the raw compaction, the first-occurrence dedup
// (`_dedup_pairwise`, :256-273) and the compaction into the list (:354-367),
// which XLA fused around the Pallas compact_rows
// (mlp_ppo_2ply_p3_tpu/ops/compaction.py:231) under use_pallas.  In place
// (`src` given) it also takes over `legal_afterstates_batch`'s non-doubles
// split, its gather back and its selection (:576-614).  Per game g:
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
// In place, with src (G,) int32, fits (G,) uint8, and of the doubles
// sub-batch dst (Gd,) int32, db_n (Gd,) int32 and db_of (Gd,) uint8, into an
// out that doubles_final has written the doubles games' rows of: src[g] >= 0
// is a non-double game, whose row is the list of game src[g] (itself, or the
// last non-double that fits the sub-batch's capacity); src[g] < 0 a doubles
// game of slot s = -1 - src[g], whose row is already there, with count
// db_n[s] and flag db_of[s].  A game that does not fit gets n = 0 and the
// flag, and a doubles one the row dst[s] of out (the last fitting doubles
// game's: s is then the last slot); a game whose mover has borne off 15
// checkers gets n = 0.  Without src, game g lists its own moves.
//
// The rules (slot predicate, afterstate, scan order) are board.cuh's.
//
// What bounds it on this card: bytes.  In place the function must read 61
// bytes a non-double game and 10 a doubles game, and write the non-double
// games' rows of the (B, M, 52) list, zeros included, and every count and
// flag: about 40 MB at B=4096 (M=256), 12 us at 3.35 TB/s.  A doubles game
// past the doubles capacity also reads and writes a row.  The list is almost all zero tail (a game has about 20 moves of
// 256), so the stores of one game's tail have to overlap the rules of the
// others.  What the design does about it:
//
// - One warp per game, four games a block, every phase warp-synchronous: no
//   block barrier, and a warp's finished stores never wait for another game.
//   A game's shared memory is small (its board, the items and rows of its
//   kept singles, and 8 bytes a listed candidate: 4.2 KB at `fast`, 16.6 KB
//   a block); 72 registers, no spills, so 7 blocks an SM and 3,696 games
//   resident at once (a doubles game's branch is a function of its own:
//   inlined, it made the compiler spill).
// - The rules run on words (board.cuh): every lane reads the board's 13
//   words and builds both first-die masks from its bit sets; the kept singles
//   are built word by word.  Lane i holds single i of both orders: it builds
//   their second-die masks the same way, and one warp scan of the two
//   popcounts (packed in one word) gives every pair its rank within its
//   order.  has2, the B-skip and the max-submove filter follow from the
//   counts alone, so each candidate knows its raw rank and only those below
//   kd (M without dedup) are listed, as (single, origin, dest, hit).
// - As soon as the counts are known, the warp stores the list's zero tail
//   past the listed candidates (16-byte stores).
// - Dedup without rows: lane j builds its candidate's packed key from its
//   single's words and the submove's byte deltas and keeps a 32-bit hash of
//   it in shared memory.  It finds the first earlier candidate with an equal
//   hash (broadcast reads); then the lanes that found one compare the two
//   keys all at once, one pass a chunk of 32 (a hash collision looks on).
//   The survivors' items are compacted in place (a ballot and popc).
// - The list goes out word by word: lane x takes word x of the rows, so the
//   warp stores consecutive words; each is its single's word plus the
//   submove's byte deltas.
// - A doubles game writes its count and flag alone; one past the doubles
//   capacity copies its row from out in 16-byte loads and stores.
//
// Nothing here allocates: the caller passes the outputs.

#include "board.cuh"

namespace {

constexpr int kGames = 4;                 // games a block: a warp each
constexpr int kThreads = 32 * kGames;
constexpr int kMaxSingles = 26;           // one die's valid slots
constexpr int kKeyWords = 7;
constexpr int kRootWords = 16;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kDup = 1u << 31;       // an item's mark: a duplicate

// Words of dynamic shared memory a game takes: its board, the items and rows
// of its kept singles (s a die order), and `limit` listed candidates (items,
// and key hashes under dedup).
__host__ __device__ inline int game_words(int s, int limit, bool dedup) {
  return kRootWords + 2 * s * (1 + kWords) + limit * (dedup ? 2 : 1);
}

// core/board.py::pack_key of the afterstate that an item names, from its
// single's row: the low 4 bits of every count.
__device__ __forceinline__ void cand_key(uint32_t (&k)[kKeyWords],
                                         const uint32_t* singles,
                                         uint32_t item) {
  const uint32_t* pw = singles + (item & 0xffu) * kWords;
  uint32_t a[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) a[w] = after_word(pw[w], item, w);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    k[i] = (a[i] & 0x0f0f0f0fu) | ((a[6 + i] & 0x0f0f0f0fu) << 4);
  }
  k[6] = a[12] & 0x0f0f0f0fu;
}

__device__ __forceinline__ uint32_t key_hash(const uint32_t (&k)[kKeyWords]) {
  uint32_t h = 2166136261u;
#pragma unroll
  for (int i = 0; i < kKeyWords; ++i) h = (h ^ k[i]) * 16777619u;
  return h;
}

// Copy one game's list (nbytes) from src to dst.
__device__ __forceinline__ void copy_list(int8_t* dst, const int8_t* src,
                                          long long nbytes, int lane) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && nbytes % 16 == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    const long long nv = nbytes / 16;
    long long i = lane;
    for (; i + 96 < nv; i += 128) {  // four loads in flight a lane
      const uint4 a = __ldg(s + i), b = __ldg(s + i + 32);
      const uint4 c = __ldg(s + i + 64), e = __ldg(s + i + 96);
      d[i] = a, d[i + 32] = b, d[i + 64] = c, d[i + 96] = e;
    }
    for (; i < nv; i += 32) d[i] = __ldg(s + i);
  } else if ((((uintptr_t)dst | (uintptr_t)src) & 3) == 0 &&
             nbytes % 4 == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (long long i = lane; i < nbytes / 4; i += 32) d[i] = __ldg(s + i);
  } else {
    for (long long i = lane; i < nbytes; i += 32) dst[i] = src[i];
  }
}

// A doubles game of slot `slot` (in place): its count and flag; past the
// doubles capacity (not `fit`) also the row of out that dst gives the slot
// (the last fitting doubles game's).  Not inlined, so that the rare copy
// takes none of the kernel's registers.
__device__ __noinline__ void place_doubles(int slot, bool fit, bool game_over,
                                           const int32_t* dst,
                                           const int32_t* db_n,
                                           const uint8_t* db_of, int8_t* out,
                                           int8_t* og, int32_t* n_g,
                                           uint8_t* overflow_g, int m,
                                           int lane) {
  const int from = dst[slot];
  if (!fit && from >= 0) {
    copy_list(og, out + (size_t)from * m * kBoard, (long long)m * kBoard,
              lane);
  }
  if (lane == 0) {
    *n_g = fit && !game_over ? db_n[slot] : 0;
    *overflow_g = (db_of[slot] != 0 || !fit) ? 1 : 0;
  }
}

// Rows [0, rows) of the list, word by word: row r is the afterstate that
// items[r] names, from its single's row.
__device__ __forceinline__ void write_rows(uint32_t* ow, const uint32_t* items,
                                           const uint32_t* singles, int rows,
                                           int lane) {
  for (int x = lane; x < rows * kWords; x += 32) {
    const int r = x / kWords, w = x - r * kWords;
    const uint32_t item = items[r];
    ow[x] = after_word(singles[(item & 0xffu) * kWords + w], item, w);
  }
}

__global__ void __launch_bounds__(kThreads)
nondoubles_kernel(const int8_t* __restrict__ vecs,
                  const int32_t* __restrict__ d_hi,
                  const int32_t* __restrict__ d_lo,
                  const uint8_t* __restrict__ mirror,
                  const int32_t* __restrict__ src,
                  const uint8_t* __restrict__ fits,
                  const int32_t* __restrict__ dst,
                  const int32_t* __restrict__ db_n,
                  const uint8_t* __restrict__ db_of,
                  int8_t* __restrict__ out, int32_t* __restrict__ n_out,
                  uint8_t* __restrict__ overflow, int games, int k1, int kd,
                  int m, int dedup, int s) {
  extern __shared__ __align__(16) uint32_t dyn[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * kGames + warp;
  if (g >= games) return;
  const int limit = dedup ? kd : m;
  uint32_t* root = dyn + (size_t)warp * game_words(s, limit, dedup != 0);
  uint32_t* sitems = root + kRootWords;              // [order][single]
  uint32_t* singles = sitems + 2 * s;                // rows, 13 words each
  uint32_t* items = singles + 2 * s * kWords;
  uint32_t* hashes = items + limit;
  int8_t* og = out + (size_t)g * m * kBoard;
  uint32_t* ow = reinterpret_cast<uint32_t*>(og);

  int source = g;
  bool fit = true;
  if (src != nullptr) {
    source = src[g];
    fit = fits[g] != 0;
  }
  const bool game_over = vecs[(size_t)g * kBoard + kMyOff] >= kCheckers;

  if (source < 0) {  // a doubles game: doubles_final wrote its list
    place_doubles(-1 - source, fit, game_over, dst, db_n, db_of, out, og,
                  n_out + g, overflow + g, m, lane);
    return;
  }

  // 1. the board
  const int8_t* vg = vecs + (size_t)source * kBoard;
  const int dh = d_hi[source], dl = d_lo[source];
  const bool mir = mirror[source] != 0;
  if (((uintptr_t)vg & 3) == 0) {
    if (lane < kWords) root[lane] = __ldg(reinterpret_cast<const uint32_t*>(vg) + lane);
  } else {
    for (int e = lane; e < kBoard; e += 32) {
      reinterpret_cast<int8_t*>(root)[e] = vg[e];
    }
  }
  __syncwarp();

  // 2. each order's first die, in scan order
  const Bits rb = row_bits(root);
  const uint32_t m1a = scan_order(slot_mask(rb, dh, 0, false), mir);
  const uint32_t m1b = scan_order(slot_mask(rb, dl, 0, false), mir);
  const int sa = min(__popc(m1a), k1), sb = min(__popc(m1b), k1);

  // 3. the kept singles: lane p holds scan position p of each order; single
  //    q = o s + i is the i-th valid first-die slot of order o
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const uint32_t mo = o ? m1b : m1a;
    if (lane < kSlots && ((mo >> lane) & 1u)) {
      const int i = __popc(mo & ((1u << lane) - 1u));
      if (i < (o ? sb : sa)) {
        sitems[o * s + i] = slot_item(rb, o * s + i, scan_slot(lane, mir),
                                      o ? dl : dh);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int so = o ? sb : sa;
    for (int x = lane; x < so * kWords; x += 32) {
      const int i = x / kWords, w = x - i * kWords;
      singles[(o * s + i) * kWords + w] =
          after_word(root[w], sitems[o * s + i], w);
    }
  }
  __syncwarp();

  // 4. the second die: lane i is single i of both orders; one scan of the
  //    two popcounts (order B's in the high half) ranks every pair
  uint32_t m2a = 0u, m2b = 0u;
  Bits ba, bb;
  if (lane < sa) {
    ba = row_bits(singles + lane * kWords);
    m2a = scan_order(slot_mask(ba, dl, 0, false), mir);
  }
  if (lane < sb) {
    bb = row_bits(singles + (s + lane) * kWords);
    m2b = scan_order(slot_mask(bb, dh, 0, false), mir);
  }
  const int c = __popc(m2a) | (__popc(m2b) << 16);
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  const int tot = __shfl_sync(kFull, x, 31);
  const int excl = x - c;
  const int pa = tot & 0xffff, pb = tot >> 16;

  // 5. emission and the max-submove filter, from the counts alone
  const bool run_b = !(pa == 0 && sa == 1);
  const bool any_pair = pa > 0 || (pb > 0 && run_b);
  // the segments' counts, in block order
  const int cnt_as = any_pair ? 0 : sa;
  const int cnt_bp = run_b ? pb : 0;
  const int cnt_bs = (any_pair || !run_b) ? 0 : sb;
  const int off_as = pa, off_bp = off_as + cnt_as, off_bs = off_bp + cnt_bp;
  const int n_raw = off_bs + cnt_bs;
  const int n_list = min(n_raw, limit);

  // the list's zero tail past every listed candidate, now
  const int listed = min(n_list, m);
  zero_words(ow + (size_t)listed * kWords, (long long)(m - listed) * kWords,
             lane, 32);

  // 6. list the candidates whose raw rank is below the limit
  if (pa > 0) {
    int r = excl & 0xffff;
    for (uint32_t mm = m2a; mm != 0u && r < limit; mm &= mm - 1u, ++r) {
      items[r] = slot_item(ba, lane, scan_slot(__ffs(mm) - 1, mir), dl);
    }
  }
  if (lane < cnt_as && off_as + lane < limit) {
    items[off_as + lane] = identity_item(lane);
  }
  if (cnt_bp > 0) {
    int r = off_bp + (excl >> 16);
    for (uint32_t mm = m2b; mm != 0u && r < limit; mm &= mm - 1u, ++r) {
      items[r] = slot_item(bb, s + lane, scan_slot(__ffs(mm) - 1, mir), dh);
    }
  }
  if (lane < cnt_bs && off_bs + lane < limit) {
    items[off_bs + lane] = identity_item(s + lane);
  }
  __syncwarp();

  int written, count;
  bool over;
  if (!dedup) {
    // 7. the raw candidates straight into the list
    written = n_list;
    count = n_raw;
    over = n_raw > m;
  } else {
    // 7. first occurrence: lane j compares its key's hash with every
    //    earlier candidate's, and the keys where the hashes are equal
    for (int c0 = 0; c0 < n_list; c0 += 32) {
      const int j = c0 + lane;
      const bool mine = j < n_list;
      uint32_t kj[kKeyWords];
      uint32_t item = 0u, hj = 0u;
      if (mine) {
        item = items[j];
        cand_key(kj, singles, item);
        hj = key_hash(kj);
        hashes[j] = hj;
      }
      __syncwarp();
      // the first earlier candidate with an equal hash; then, all such
      // lanes at once, its key; on a hash collision the next one
      const int end = min(c0 + 32, n_list);
      int match = -1;
#pragma unroll 4
      for (int i = 0; i < end; ++i) {
        const uint32_t hi = hashes[i];
        if (mine && match < 0 && i < j && hi == hj) match = i;
      }
      bool dup = false;
      while (__any_sync(kFull, match >= 0)) {
        if (match >= 0) {
          uint32_t ki[kKeyWords];
          cand_key(ki, singles, items[match]);
          bool eq = true;
#pragma unroll
          for (int w = 0; w < kKeyWords; ++w) eq = eq && ki[w] == kj[w];
          int next = -1;
          for (int i = match + 1; !eq && next < 0 && i < j; ++i) {
            if (hashes[i] == hj) next = i;
          }
          dup = eq;
          match = eq ? -1 : next;
        }
      }
      __syncwarp();
      if (dup) items[j] = item | kDup;
    }
    __syncwarp();

    // 8. the survivors' items to the front, in order
    int uniq = 0;
    for (int c0 = 0; c0 < n_list; c0 += 32) {
      const int j = c0 + lane;
      const uint32_t item = j < n_list ? items[j] : kDup;
      const bool keep = (item & kDup) == 0u;
      const uint32_t bal = __ballot_sync(kFull, keep);
      const int u = uniq + __popc(bal & ((1u << lane) - 1u));
      __syncwarp();
      if (keep && u < m) items[u] = item;
      uniq += __popc(bal);
    }
    __syncwarp();
    written = min(uniq, m);
    count = uniq;
    over = n_raw > kd || uniq > m;
    // the rows between the survivors and the listed candidates
    zero_words(ow + (size_t)written * kWords,
               (long long)(listed - written) * kWords, lane, 32);
  }
  // 9. the list, word by word
  write_rows(ow, items, singles, written, lane);
  if (lane == 0) {
    n_out[g] = fit && !game_over ? min(count, m) : 0;
    overflow[g] = (over || !fit) ? 1 : 0;
  }
}

}  // namespace

// Pointers are device pointers; src, fits, dst, db_n and db_of are all null
// (each game lists its own moves) or all given (in place, dst (Gd,) int32,
// out holding the rows doubles_final wrote).  out (G, m, 52) must start on a
// 4-byte boundary.  Returns the CUDA
// error of the launch (0: launched); cudaErrorInvalidValue where the widths
// need more shared memory than a block may have.
extern "C" int nondoubles_launch(const void* vecs, const void* d_hi,
                                 const void* d_lo, const void* mirror,
                                 const void* src, const void* fits,
                                 const void* dst, const void* db_n,
                                 const void* db_of, void* out, void* n_out,
                                 void* overflow, int games, int k1, int kd,
                                 int m, int dedup, void* stream) {
  // the most dynamic shared memory a block gets, for each card apart (the
  // opt-in is the current card's); 0: not set yet
  static int max_dyn[kMaxDevices] = {};
  if (games <= 0) return (int)cudaGetLastError();
  const int limit = dedup ? kd : m;
  if (k1 < 1 || kd < 0 || m < 0 || limit > 65535 ||
      (uintptr_t)out % 4 != 0) {
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
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, nondoubles_kernel);
    const int most = optin - (int)attr.sharedSizeBytes;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(nondoubles_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    }
    if (err != cudaSuccess) return (int)err;
    max_dyn[dev] = most;
  }
  const int s = k1 < kMaxSingles ? k1 : kMaxSingles;
  const size_t smem = (size_t)4 * kGames * game_words(s, limit, dedup != 0);
  if (smem > (size_t)max_dyn[dev]) return (int)cudaErrorInvalidValue;
  nondoubles_kernel<<<(games + kGames - 1) / kGames, kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const int8_t*)vecs, (const int32_t*)d_hi, (const int32_t*)d_lo,
      (const uint8_t*)mirror, (const int32_t*)src, (const uint8_t*)fits,
      (const int32_t*)dst, (const int32_t*)db_n, (const uint8_t*)db_of,
      (int8_t*)out, (int32_t*)n_out, (uint8_t*)overflow, games, k1, kd, m,
      dedup, s);
  return (int)cudaGetLastError();
}
