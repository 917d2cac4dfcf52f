// The afterstate evaluation pass for Hopper (sm_90a), forward and backward:
// int8 canonical boards through the 198 TD-Gammon features, fc1, ReLU and one
// head, then an epilogue.  Per board (row r, slot s) of boards (R, M, 52):
//
//   feats = encode_canonical(view(board), mover[r])    (198 floats)
//   h     = relu(W1 feats + b1)                        (W1 (H, 198), b1 (H,))
//   y     = w_head . h + b_head                        (w_head (1, H))
//
// view is the identity or core/board.py::opponent_view.  Epilogues, with
// n (R,) the valid-prefix lengths: logits (y where s < n, else -1e9; a row
// with n <= 0 keeps every raw y), masked (sign y where s < n, else -1e9) and
// min (the (R,) minimum of y over s < n, +1e9 where there is none).
//
// It replaces jnp that XLA fuses in the JAX package: the features, fc1 and
// the score head of ppo/learner.py:143-152 (_afterstate_logits), the value
// head of agents/basic.py::afterstate_values and the score head of
// ::afterstate_policy_logits, and agents/twoply.py:108-131
// (_masked_min_values), all in mlp_ppo_2ply_p3_tpu/; the backward replaces
// XLA's autodiff of the same (ppo/learner.py:204-208).
//
// What bounds it on this card.  Only the kept boards need work (slot <
// row_limit: about 32 of a row's 256 slots at a rollout step).  Counted on
// their non-zero features the pass is a few GFLOP and its bound is set by
// operations at the float32 rate (0.0088 ms a rollout step, 0.0355 ms a
// minibatch's backward); as dense products, 2 x 198 x H flops a kept board
// and as much again for dW1, about 13 GFLOP a minibatch, which the bf16
// tensor cores do in about 0.013 ms a product.  So the design runs the
// dense products on the tensor cores, exactly (below), and keeps the rest
// (bytes, decoding, reductions) off their way:
//
// - Tiles of kept boards, not rows.  The kept boards, row by row in slot
//   order, are numbered 0 .. N-1 and cut into tiles of 64 (the last one
//   short).  Every block scans row_limit over all rows itself (a thread a
//   run of rows, then one block scan), so it knows N and the row and
//   offset where its tiles start; a block takes a contiguous range of
//   tiles, so every block gets the same number of full tiles whatever the
//   rows hold, and a row may straddle tiles and blocks.  It maps each
//   tile's boards to their (row, slot) by a binary search in a window of
//   256 rows' offsets, scanned again when the tiles pass its end.
// - The boards' 52 bytes (and the backward's output gradients) come into a
//   ring of two tiles by cp.async a tile ahead, so their DRAM latency hides
//   behind the previous tile's products.  Two block barriers a tile.
// - Each kept board is decoded once a block, four threads a board (12
//   point bytes each, read as three words): the (64 x 208) bf16 feature
//   tile (198 features and 10 zero columns).  Every feature but the two
//   off ones (97, 195) is exact in bf16 for every int8 byte: 0, 1,
//   (c - 3) / 2, c / 2 and the one-hot.  The off features,
//   __fmul_rn(c, float32(1/15)) as core/features.py computes them, are
//   kept in float32 beside the tile and their columns are zero.  The frame
//   flip and opponent_view are index arithmetic on the board's bytes.
// - fc1 is wgmma m64n64k16 (bf16 in, float32 out) as units x boards:
//   warpgroup q takes units 64 q .. 64 q + 63 of W1, resident in shared
//   memory as three bf16 parts hi + mid + lo (the off columns zero).  hi +
//   mid + lo == W1 exactly for every float32 |w| in [2^-110, 2^127) (each
//   part takes the next 8 of the 24 bits; below 2^-110 lo falls under
//   bf16's smallest subnormal, an error under 2^-134), and a feature (at
//   most 7 significant bits) times a part (8 bits) is exact in float32, so
//   the products are W1's own and only the order of the sums changes.  Each
//   k-step's three products (lo, mid, hi) go into a fragment that the
//   first one overwrites, which is then added to the running sum in
//   float32, so the tensor core's rounding of its sums reaches one
//   16-feature partial only.  (Two bf16 parts leave up to 2^-16 of W1 out,
//   1e-4 of a pre-activation; a TF32 split needs 32-bit parts, 4/3 of the
//   shared memory, at half the rate.)  The forward runs two such fragments
//   in turn, so the next k-step's products run while one is added; the
//   backward, short of registers, waits for each.  Operands sit in shared
//   memory in 8 x 8 core matrices without swizzle, the layout the wgmma
//   descriptors read; W1's parts take 156 KB, the tile 26 KB, 205 KB in
//   all, one block of 256 threads an SM.  The off columns, the bias, ReLU,
//   the head's dot product (a reduce-scatter over lanes, then over the
//   warps in shared memory), sign, floor and min run in registers.
// - Backward, in the same block: the tile's pre-activations as in the
//   forward, dpre = d w_head [pre > 0] with d = sign grad in place, and
//   dW1 += dpre^T X by mma.sync m16n8k16: a warp's accumulator fragments
//   (16 units x 64 boards) are the A operands as they stand, split in three
//   bf16 parts like W1, and ldmatrix.trans reads the feature tile as B.  A
//   warp's (16 units x 208 features) of dW1 stay in registers over the
//   block's tiles, each 16-board step's three products again in a zeroed
//   fragment added in float32.  db1, dw_head, dW1's off columns and
//   db_head are float32 sums in a fixed order.  Nothing of the forward is
//   saved for the backward: recomputing pre costs a third of the block's
//   products, keeping it would cost (R, M, H) floats.
// - Any hidden width H >= 1, in unit groups of 128: a block stages the
//   128 units of its group, and the units at or past H as zero W1 rows, zero
//   b1 and zero w_head, so that each adds relu(0) x 0 = 0 exactly (H < 128
//   stages one whole group).  H <= 128 is one block's group.  128 < H <=
//   256 does not fit one block (312 KB of parts): the forward runs clusters
//   of two blocks, each with its group, both decoding the same tiles, and
//   the head's two partial sums meet through distributed shared memory
//   (rank 0 adds rank 1's and writes).  H > 256: a grid of tile ranges x
//   ceil(H / 128) groups, each block writing its group's head partial of
//   every kept board into scratch ((groups, R x M) floats), and a second
//   kernel that sums the groups in order, adds b_head and applies the
//   epilogue (the min a warp a row).  The backward runs a grid of
//   ceil(H / 128) unit groups at every width, which share nothing but d.
// - bfloat16 (compute_dtype "bfloat16", bf16 weights), the form the JAX
//   package computes (models/mlp.py:_dense): the features are rounded to
//   bf16, the off columns too, so they sit in the tile; W1 is one bf16
//   part (52 KB a group); fc1 accumulates in float32 on wgmma over all 13
//   k-steps, is rounded to bf16, b1 is added and the sum rounded (JAX's two
//   roundings; torch's bf16 linear rounds once, after the bias), ReLU; the
//   head's dot product accumulates in float32, is rounded, b_head added and
//   rounded, then widened to float32.  Backward: d = bf16(sign grad), dpre
//   = bf16(d w_head) where pre > 0, dW1 += dpre^T X on mma.sync with one
//   part (dpre and X are bf16 numbers), db1, dw_head, db_head float32 sums;
//   every gradient rounded to bf16 once, after the block partials are
//   summed (the cotangent of JAX's astype(bfloat16)).  The shared layouts
//   are the float32 form's (part 0 of W1's), so the wgmma descriptors are
//   the same.
// - A routed pass (two networks, each kept board through its class's): a
//   route kernel reads each kept board's bytes, writes the floors and lays
//   each class's kept slots out row by row; the emit (kRoute) and the deep
//   backward (kRouted) then walk one class's kept boards as their global
//   order, a launch a network, the single network's code unchanged.
// - A whole row is one kept board.  Under the logits epilogue a row with n
//   <= 0 keeps every slot, and movegen fills such a row (no legal move)
//   with one board, its zero tail, in all m slots: m equal values, whose
//   cotangents (log-softmax and entropy terms) sum to about nothing.  A row
//   with n <= 0 whose m boards all equal slot 0, byte for byte, is whole:
//   it keeps slot 0 alone, the forward writes that board's value (sign
//   included) into each of the row's m slots (a warp a row, coalesced), and
//   the backward gives it the row's m cotangents summed in float32 in a
//   fixed order (afterstate_whole_grad_kernel before the backward, a warp
//   a row: each lane its slots lane, lane + 32, ..., then a butterfly), the
//   gradient of m equal values being that of one with the summed
//   cotangent.  A row whose boards differ keeps all m, as before.
//   afterstate_collapse_kernel (a warp a row, reading only the rows with n
//   <= 0) writes each row's entry of lim: its kept boards, or kWhole; the
//   route kernel decides the same from the bytes it reads anyway.  Every
//   form walks lim as the routed forms walk a class's counts; the deep
//   forms mark a whole row's board in elem as ~(r m), for csrc/dense.cu's
//   head, which writes and reads the row's m slots.  Both add the whole
//   rows they find to a tally on the card.  The masked and min epilogues
//   keep nothing of a row with n <= 0, so they take no lim, and the
//   forward's instances for them (kLim false) carry none of this code.
// - Deterministic: every board's value is computed the same way wherever
//   it runs, the min is an atomic min on the float's bits (exact in any
//   order; a first kernel writes the +1e9) or, past 256 units, a warp's
//   fixed-order min, and no float sum uses an atomic.  The backward's
//   blocks are min(tiles of R x M, max(132 / groups, 1)), a number of the
//   shapes (never of the card; ops/afterstate.py::backward_blocks), each
//   with a contiguous range of tiles of the data; each writes its partial
//   gradient and a second kernel sums the partials of each entry in block
//   order.  The forward's grid may follow the card.
//
// nvcc contracts a * b + c into an FMA in the epilogues, which the
// tolerance allows.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "whole_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBoard = 52;
constexpr int kFeatures = 198;
constexpr int kOff0 = 97, kOff1 = 195;  // the off features, kept in float32
constexpr float kInvCheckers = 0x1.111112p-4f;  // float32(1 / 15)
constexpr float kFloor = -1e9f;
constexpr float kPosInf = 1e9f;
constexpr int kLogits = 0, kMasked = 1, kMin = 2;
constexpr unsigned kFull = 0xffffffffu;
// the forward's grids: one block's unit group (H <= 128), a cluster of two
// (H <= 256), tile ranges x unit groups with a second kernel (H > 256)
// kEmit: a deep network's fc1, tile ranges x unit groups as kSplit, each
// writing relu(pre) of its units for every kept board (csrc/dense.cu takes
// the layers after it); kRoute: kEmit over one group of a routed pass (the
// kept boards of one class, in the order afterstate_route_kernel lays out)
constexpr int kSingle = 0, kPair = 1, kSplit = 2, kEmit = 3, kRoute = 4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;               // kept boards a tile
constexpr int kUnits = 128;             // hidden units a block
constexpr int kK = 208;                 // the features padded to 13 x 16
constexpr int kKSteps = kK / 16;
constexpr int kWords = kK / 2;          // bf16 pairs a feature row
// Shared operands are tiled in 8 x 8 bf16 core matrices (128 contiguous
// bytes, rows of 16 bytes), the 26 of a group of 8 rows in feature order:
// wgmma's layout without swizzle, whose descriptor takes the stride between
// core matrices along K (128 bytes) and between row groups (3,328).
constexpr int kKG = kK / 8;             // core matrices a row group
constexpr int kGroupBytes = kKG * 128;  // 3,328
constexpr int kParts = 3;               // hi, mid, lo
constexpr int kWindow = 256;            // rows a scan window

// Shared memory of a block, carved in this order (every piece a multiple
// of 16 bytes but the last).
constexpr size_t kPartBytes = (size_t)kUnits / 8 * kGroupBytes;  // 53,248
constexpr size_t kSmemW = kParts * kPartBytes;               // 159,744
constexpr size_t kSmemX = (size_t)kTile / 8 * kGroupBytes;   // 26,624
constexpr size_t kSmemRing = 2ull * kTile * kBoard;          // 6,656
constexpr size_t kSmemUnit = 4ull * 8 * kUnits;   // b1 wh w97 w195, sums
constexpr size_t kSmemTileF = 4ull * (2 * kTile + kWarps * kTile + 2 * kTile +
                                      kTile);  // offv ysum yx dval
constexpr size_t kSmemTileI = 4ull * 4 * 2 * kTile;   // e row mover grad x2
constexpr size_t kSmemWin = 4ull * (2 * kWindow + 1 + 16);
constexpr size_t kSmemWhole = 4ull * (2 * kTile + kWindow);  // the flags
constexpr size_t kSmem = kSmemW + kSmemX + kSmemRing + kSmemUnit +
                         kSmemTileF + kSmemTileI + kSmemWin + kSmemWhole;

struct Args {
  const int8_t* boards;
  const int32_t* mover;
  const int32_t* n;
  const void* w1;      // the weights: float32, or bf16 in the bf16 form
  const void* b1;
  const void* wh;
  const void* bh;
  const float* grad;   // backward only
  const float* wgrad;  // backward: each whole row's m entries of grad summed
  float* out;          // forward: the output; backward: the partials
  float* part;         // the forward past 256 units: (groups, rows m)
  float* h1;           // kEmit: (kept capacity, ldh) relu(pre) of each board
  int* elem;           // kEmit: each kept board's element r m + s
  int* count;          // kEmit: the number of kept boards
  const float* dpre;   // the deep backward: fc1's dpre, (capacity, ldh)
  const int* lim;      // each row's entry (kWhole, or its kept boards): the
                       // collapse pass's (logits, else null), or a routed
                       // group's of its class (the route kernel's)
  const int* rslot;    // a routed group: each row's kept slots of the class,
                       // row r at r m ..
  unsigned long long* tally;  // kRoute: the group's kept boards, summed
  int ldh;
  int rows, m, hidden, opponent, epilogue;
  float sign;
  int aligned;         // boards 4-byte aligned: cp.async, else byte loads
};

// A block's shared memory.
struct Smem {
  uint16_t* w;      // [3] W1's parts (bf16 bits), 128 units x 208 features
                    // (the bf16 form: part 0 alone)
  uint16_t* x;      // the tile's features (bf16 bits), 64 boards x 208
  int8_t* ring;     // [2][64][52] the boards' bytes
  float* b1;        // [128]
  float* wh;        // [128]
  float* w97;       // [128] W1's off columns (float32 form)
  float* w195;      // [128]
  float* gsum;      // [4][128] the backward's db1, dw_head, dW1[:, 97], [195]
  float* offv;      // [64][2] the tile's off features
  float* ysum;      // [8][64] the warps' head partials
  float* yx;        // [2][64] the cluster's head partials
  float* dval;      // [64] sign grad
  int* te;          // [2][64] element r m + s, -1 past the tile's end
  int* trow;        // [2][64]
  int* tmv;         // [2][64] mover
  float* tgrad;     // [2][64]
  int* twhole;      // [2][64] 1: the board stands for its whole row
  int* woff;        // [257] the window's offsets
  int* wmv;         // [256] the window's movers
  int* wwhole;      // [256] 1: the window's row is whole
  int* sc;          // [16] scan partials, [8] start row, [9] its offset,
                    // [10] kept boards, [11] the window's first row
};

__device__ __forceinline__ Smem carve(unsigned char* p) {
  Smem s;
  s.w = reinterpret_cast<uint16_t*>(p);
  p += kSmemW;
  s.x = reinterpret_cast<uint16_t*>(p);
  p += kSmemX;
  s.ring = reinterpret_cast<int8_t*>(p);
  p += kSmemRing;
  float* f = reinterpret_cast<float*>(p);
  s.b1 = f;
  s.wh = f + kUnits;
  s.w97 = f + 2 * kUnits;
  s.w195 = f + 3 * kUnits;
  s.gsum = f + 4 * kUnits;
  f += 8 * kUnits;
  s.offv = f;
  s.ysum = f + 2 * kTile;
  s.yx = s.ysum + kWarps * kTile;
  s.dval = s.yx + 2 * kTile;
  int* i = reinterpret_cast<int*>(s.dval + kTile);
  s.te = i;
  s.trow = i + 2 * kTile;
  s.tmv = i + 4 * kTile;
  s.tgrad = reinterpret_cast<float*>(i + 6 * kTile);
  i += 8 * kTile;
  s.woff = i;
  s.wmv = i + kWindow + 1;
  s.sc = s.wmv + kWindow;
  s.twhole = s.sc + 16;
  s.wwhole = s.twhole + 2 * kTile;
  return s;
}

// The slots [0, limit) of a row that its epilogue keeps.
__device__ __forceinline__ int row_limit(int n, int m, int epilogue) {
  if (epilogue == kLogits && n <= 0) return m;
  return n < 0 ? 0 : (n > m ? m : n);
}

// A row's entry in lim where it is whole: one board, slot 0, for all m.
constexpr int kWhole = -1;

// The row's entry: lim's where there is one (a routed group's always), else
// its slot limit.  kLim false: a.lim is never set (the forward's masked and
// min forms, compiled without the whole rows' code).
template <bool kRouted = false, bool kLim = true>
__device__ __forceinline__ int lim_of(const Args& a, int r) {
  if (kRouted || (kLim && a.lim != nullptr)) return a.lim[r];
  return row_limit(a.n[r], a.m, a.epilogue);
}

// The row's kept boards (kRouted: of the routed group's class).
template <bool kRouted = false, bool kLim = true>
__device__ __forceinline__ int limit_of(const Args& a, int r) {
  const int l = lim_of<kRouted, kLim>(a, r);
  return l == kWhole ? 1 : l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The 32-bit word (features 2 w, 2 w + 1) of row r in the core-matrix
// layout.
__device__ __forceinline__ int cm_word(int r, int w) {
  return ((r >> 3) * kKG + (w >> 2)) * 32 + (r & 7) * 4 + (w & 3);
}

// The operands written by threads become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x rounded to bf16 (to nearest, ties to even), as a float.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Entry i of a weight tensor, float32 or (kBf16) bf16.
template <bool kBf16>
__device__ __forceinline__ float weight(const void* p, size_t i) {
  if constexpr (kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

// x = hi + mid + lo, each bf16 rounded to nearest from what is left.
__device__ __forceinline__ void split3(float x, uint32_t (&p)[kParts]) {
  float r = x;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const __nv_bfloat16 b = __float2bfloat16_rn(r);
    p[k] = __bfloat16_as_ushort(b);
    r = r - __bfloat162float(b);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b on the tensor cores (m16n8k16, bf16 in, float32 out).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The exclusive prefix of v over the block's threads; total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* part,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? part[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) part[lane] = w;
  }
  __syncthreads();
  const int base = warp ? part[warp - 1] : 0;
  total = part[kWarps - 1];
  __syncthreads();
  return base + x - v;
}

// The block's rows [r_lo, r_hi) of a thread: the sum of their kept boards
// (limit(r) each), then, where board g0 lies among them, its row and the
// kept boards before that row (sc[8], sc[9]); base is the thread's first
// kept board, total all the rows'.
template <class Limit>
__device__ __forceinline__ void locate_rows(const Smem& s, Limit limit,
                                            int r_lo, int r_hi, int group,
                                            int groups, int& t0, int& t1) {
  int sum = 0;
#pragma unroll 16
  for (int r = r_lo; r < r_hi; ++r) sum += limit(r);
  int total;
  const int base = block_exclusive_scan(sum, s.sc, total);
  const long long tiles = (total + kTile - 1) / kTile;
  t0 = (int)(tiles * group / groups);
  t1 = (int)(tiles * (group + 1) / groups);
  const int g0 = t0 * kTile;
  if (t0 < t1 && base <= g0 && g0 < base + sum) {
    int off = base, row = r_lo, row_off = base;
#pragma unroll 16
    for (int r = r_lo; r < r_hi; ++r) {   // no break: the loads overlap
      const int l = limit(r);
      if (off <= g0 && g0 < off + l) {
        row = r;
        row_off = off;
      }
      off += l;
    }
    s.sc[8] = row;
    s.sc[9] = row_off;
  }
  if (threadIdx.x == 0) s.sc[10] = total;
}

// Every block's view of the kept boards: their number N (sc[10]) and, for
// the block's tiles [t0, t1) of ceil(N / 64) cut into `groups` contiguous
// ranges, the row holding board 64 t0 and the number of kept boards before
// that row (sc[8], sc[9]).  kRouted: of a routed group's kept boards.  The
// choice between lim and the slot limits is made once, outside the loops,
// whose loads then overlap as they would with either alone.
template <bool kRouted = false, bool kLim = true>
__device__ void locate(const Args& a, const Smem& s, int group, int groups,
                       int& t0, int& t1) {
  const int per = (a.rows + kThreads - 1) / kThreads;
  const int r_lo = min(a.rows, (int)threadIdx.x * per);
  const int r_hi = min(a.rows, r_lo + per);
  if (kRouted || (kLim && a.lim != nullptr)) {
    const auto by_lim = [&](int r) {
      const int l = a.lim[r];
      return l == kWhole ? 1 : l;
    };
    locate_rows(s, by_lim, r_lo, r_hi, group, groups, t0, t1);
  } else {
    const auto by_n = [&](int r) {
      return row_limit(a.n[r], a.m, a.epilogue);
    };
    locate_rows(s, by_n, r_lo, r_hi, group, groups, t0, t1);
  }
  __syncthreads();
}

// Rows row0 .. row0 + 255 (past the end: empty) into the window, their first
// kept boards' numbers from off0 on.
template <bool kRouted = false, bool kLim = true>
__device__ void load_window(const Args& a, const Smem& s, int row0,
                            int off0) {
  const int r = row0 + (int)threadIdx.x;
  int l = 0, mv = 0, whole = 0;
  if (r < a.rows) {
    l = lim_of<kRouted, kLim>(a, r);
    whole = l == kWhole;
    l = whole ? 1 : l;
    mv = a.mover[r];
  }
  int total;
  const int ex = block_exclusive_scan(l, s.sc, total);
  s.woff[threadIdx.x] = off0 + ex;
  s.wmv[threadIdx.x] = mv;
  if constexpr (kRouted || kLim) s.wwhole[threadIdx.x] = whole;
  if (threadIdx.x == 0) {
    s.woff[kWindow] = off0 + total;
    s.sc[11] = row0;
  }
  __syncthreads();
}

// The tile of kept boards g .. g + cnt - 1 into slot buf: each board's
// element, row and mover, and its bytes (and the backward's gradient)
// copied in by cp.async (not waited for).  kRouted: the j-th kept board of
// a row is its j-th kept slot of the group's class.
template <bool kRouted = false, bool kLim = true>
__device__ void map_tile(const Args& a, const Smem& s, int buf, int g,
                         int cnt, bool backward) {
  const int b = threadIdx.x;
  int done = 0;
  for (;;) {
    const int wend = s.woff[kWindow];
    if (g + done >= wend) {   // the window is spent: the next 256 rows
      const int row0 = s.sc[11] + kWindow;
      __syncthreads();
      load_window<kRouted, kLim>(a, s, row0, wend);
      continue;
    }
    const int upto = min(cnt, wend - g);
    if (b >= done && b < upto) {
      const int gb = g + b;
      int lo = 0, hi = kWindow - 1;   // the last row starting at or before gb
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s.woff[mid] <= gb) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int row = s.sc[11] + lo;
      const int j = gb - s.woff[lo];
      const int e = row * a.m + (kRouted ? a.rslot[row * a.m + j] : j);
      const int k = buf * kTile + b;
      s.te[k] = e;
      s.trow[k] = row;
      s.tmv[k] = s.wmv[lo];
      if constexpr (kRouted || kLim) s.twhole[k] = s.wwhole[lo];
      const int8_t* src = a.boards + (size_t)e * kBoard;
      int8_t* dst = s.ring + k * kBoard;
      if (a.aligned) {
#pragma unroll
        for (int q = 0; q < kBoard; q += 4) cp_async4(dst + q, src + q);
      } else {
        for (int q = 0; q < kBoard; ++q) dst[q] = src[q];
      }
      if (backward) {   // a whole row's: its m cotangents summed
        const bool whole = (kRouted || kLim) && s.wwhole[lo];
        cp_async4(s.tgrad + k, whole ? a.wgrad + row : a.grad + e);
      }
    }
    done = upto;
    if (done >= cnt) break;
    __syncthreads();
  }
  if (b >= cnt && b < kTile) {
    const int k = buf * kTile + b;
    s.te[k] = -1;
    s.trow[k] = -1;
    s.tmv[k] = 0;
    if constexpr (kRouted || kLim) s.twhole[k] = 0;
  }
}

// bf16 bits of the exact values a byte sets, two features a 32-bit word.
constexpr uint32_t kOne = 0x3f80u;   // bf16 1.0

// The word of features 4 p, 4 p + 1 (c >= 1, c >= 2) and of 4 p + 2, 4 p + 3
// (c >= 3, (c - 3) / 2 where c > 3) of a point holding c; (c - 3) / 2 and
// c / 2 have at most 8 significant bits, so a float's top half is its bf16.
__device__ __forceinline__ uint32_t point_lo(int c) {
  return (c >= 1 ? kOne : 0u) | (c >= 2 ? kOne << 16 : 0u);
}
__device__ __forceinline__ uint32_t point_hi(int c) {
  return (c >= 3 ? kOne : 0u) |
         (c > 3 ? __float_as_uint((float)(c - 3) * 0.5f) & 0xffff0000u : 0u);
}

// The tile in slot buf into the feature tile (bf16, the off columns zero,
// rows past the tile's end zero), the off features into offv and, for the
// backward, sign grad (0 past the end) into dval.  Four threads a board:
// thread (b, q, h) writes points 12 h .. 12 h + 11 of player q (12 bytes of
// the board, read as three words), h = 1 also player q's bar word and q = h
// = 1 the one-hot and the padding.  kBf16: the off features rounded to bf16
// in their columns (no offv), and dval rounded to bf16.
template <bool kBf16>
__device__ void decode_tile(const Args& a, const Smem& s, int buf,
                            bool backward) {
  const int b = threadIdx.x >> 2, q = (threadIdx.x >> 1) & 1,
            h = threadIdx.x & 1;
  const int k = buf * kTile + b;
  const int e = s.te[k];
  uint32_t* x32 = reinterpret_cast<uint32_t*>(s.x);
  const int w0 = 49 * q + 24 * h;   // this thread's first point word
  if (e < 0) {
#pragma unroll
    for (int i = 0; i < 24; ++i) x32[cm_word(b, w0 + i)] = 0u;
    if (h) x32[cm_word(b, 49 * q + 48)] = 0u;
    if (q & h) {
#pragma unroll
      for (int w = 98; w < kWords; ++w) x32[cm_word(b, w)] = 0u;
    }
  } else {
    const int mv = s.tmv[k];
    const int flip = (mv != 0) ^ a.opponent;
    const int8_t* bb = s.ring + k * kBoard;
    // points 12 h + i of player q are bytes start + i, or start + 11 - i
    // flipped (absolute point 24 q + 12 h + i is canonical byte 47 - it)
    const int start = flip ? 36 - 24 * q - 12 * h : 24 * q + 12 * h;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(bb + start);
    const uint32_t w[3] = {src[0], src[1], src[2]};
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int straight = (int8_t)(w[i >> 2] >> (8 * (i & 3)));
      const int reversed = (int8_t)(w[(11 - i) >> 2] >> (8 * ((11 - i) & 3)));
      const int c = flip ? reversed : straight;
      x32[cm_word(b, w0 + 2 * i)] = point_lo(c);
      x32[cm_word(b, w0 + 2 * i + 1)] = point_hi(c);
    }
    if (h) {   // player q's bar; its off feature is kept in float32
      uint32_t word = __float_as_uint((float)bb[48 + (q ^ flip)] * 0.5f) >> 16;
      if constexpr (kBf16) {   // or rounded to bf16 in its column
        const float off = __fmul_rn((float)bb[50 + (q ^ flip)], kInvCheckers);
        word |= (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(off)) << 16;
      }
      x32[cm_word(b, 49 * q + 48)] = word;
    }
    if (q & h) {
      x32[cm_word(b, 98)] =
          (mv == 0 ? kOne : 0u) | (mv == 1 ? kOne << 16 : 0u);
#pragma unroll
      for (int w = 99; w < kWords; ++w) x32[cm_word(b, w)] = 0u;
    }
  }
  fence_async_shared();
  if (!kBf16 && threadIdx.x < 2 * kTile) {
    const int bo = threadIdx.x >> 1, qo = threadIdx.x & 1;
    const int ko = buf * kTile + bo;
    int c = 0;
    if (s.te[ko] >= 0) {
      const int flip = (s.tmv[ko] != 0) ^ a.opponent;
      c = s.ring[ko * kBoard + 50 + (qo ^ flip)];
    }
    s.offv[threadIdx.x] = __fmul_rn((float)c, kInvCheckers);
  }
  if (backward && threadIdx.x < kTile) {
    const int kd = buf * kTile + threadIdx.x;
    const float d = s.te[kd] >= 0 ? a.sign * s.tgrad[kd] : 0.0f;
    s.dval[threadIdx.x] = kBf16 ? bf16r(d) : d;
  }
}

// W1's rows u0 .. u0 + 127 into shared memory as three bf16 parts (the off
// columns and the padding zero), and b1, w_head and the off columns of
// those units in float32; units at or past H as zeros.  A thread's 52
// feature pairs: every load issued before any is used.  kBf16: W1's bf16
// rows as they are, one part, the off columns in it.
template <bool kBf16>
__device__ void stage_weights(const Args& a, const Smem& s, int u0) {
  constexpr int kPer = kUnits * kWords / kThreads;   // 52
  constexpr int kBatch = kPer;
  uint32_t* w32 = reinterpret_cast<uint32_t*>(s.w);
  if constexpr (kBf16) {
    const uint16_t* w1 = static_cast<const uint16_t*>(a.w1);
    uint32_t v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int j = i / kWords, f = 2 * (i - j * kWords);
      const bool live = u0 + j < a.hidden;
      const uint16_t* row = w1 + (size_t)(u0 + j) * kFeatures;
      const uint32_t lo = live && f < kFeatures ? row[f] : 0u;
      const uint32_t hi = live && f + 1 < kFeatures ? row[f + 1] : 0u;
      v[k] = lo | (hi << 16);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int j = i / kWords, w = i - j * kWords;
      w32[cm_word(j, w)] = v[k];
    }
  } else {
    const float* w1 = static_cast<const float*>(a.w1);
#pragma unroll 1
    for (int b0 = 0; b0 < kPer; b0 += kBatch) {
      float v[kBatch][2];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = threadIdx.x + (b0 + k) * kThreads;
        const int j = i / kWords, f = 2 * (i - j * kWords);
        const bool live = u0 + j < a.hidden;
        const float* row = w1 + (size_t)(u0 + j) * kFeatures;
        // f is even, so never an off column; f + 1 may be
        v[k][0] = live && f < kFeatures ? row[f] : 0.0f;
        v[k][1] = live && f + 1 < kFeatures && f + 1 != kOff0 &&
                          f + 1 != kOff1
                      ? row[f + 1]
                      : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = threadIdx.x + (b0 + k) * kThreads;
        const int j = i / kWords, w = i - j * kWords;
        uint32_t p0[kParts], p1[kParts];
        split3(v[k][0], p0);
        split3(v[k][1], p1);
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          w32[p * (kPartBytes / 4) + cm_word(j, w)] = p0[p] | (p1[p] << 16);
        }
      }
    }
  }
  fence_async_shared();
  if (threadIdx.x < kUnits) {
    const int j = threadIdx.x, u = u0 + j;
    const bool live = u < a.hidden;
    s.b1[j] = live ? weight<kBf16>(a.b1, u) : 0.0f;
    s.wh[j] = live ? weight<kBf16>(a.wh, u) : 0.0f;
    if constexpr (!kBf16) {
      const float* row =
          static_cast<const float*>(a.w1) + (size_t)u * kFeatures;
      s.w97[j] = live ? row[kOff0] : 0.0f;
      s.w195[j] = live ? row[kOff1] : 0.0f;
    }
  }
}

// A shared-memory matrix descriptor of the core-matrix layout at addr.
__device__ __forceinline__ uint64_t cm_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(kGroupBytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A B^T for a warpgroup: A 64 x 16 and B 64 x 16 bf16, both K-major
// in shared memory (descriptors), d 64 x 64 float32; scale 0 overwrites d.
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale));
}

// The tile's pre-activations without the off columns and the bias, as
// units x boards: warpgroup q computes units 64 q .. 64 q + 63 of the
// block's 128 for the 64 boards, so warp w holds units 16 w + g and
// 16 w + g + 8 (acc[4 i + 0, 1] and acc[4 i + 2, 3]) of boards 8 i + 2 t
// and 8 i + 2 t + 1.  A k-step's three products (lo, mid, hi) go into a
// fragment they overwrite first; it is added to acc once they are done,
// while the next k-step's run (two fragments in turn).
// kLean (the backward, whose dW1 holds 104 registers a thread): one such
// fragment, each k-step waited for.  kBf16: W1's one part, every k-step
// into acc on the tensor cores.
template <bool kLean, bool kBf16>
__device__ __forceinline__ void fc1_tile(const Smem& s, float (&acc)[32]) {
  const int wg = threadIdx.x >> 7;
  const unsigned wa = smem_addr(s.w) + 8 * wg * kGroupBytes;
  const unsigned xa = smem_addr(s.x);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  if constexpr (kBf16) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const unsigned k = 256 * kk;
      wgmma64(acc, cm_desc(wa + k), cm_desc(xa + k), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
  } else if constexpr (kLean) {
    float t[32];
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const unsigned k = 256 * kk;
      const uint64_t dx = cm_desc(xa + k);
      wgmma_fence();
      wgmma64(t, cm_desc(wa + 2 * (unsigned)kPartBytes + k), dx, 0);
      wgmma64(t, cm_desc(wa + (unsigned)kPartBytes + k), dx, 1);
      wgmma64(t, cm_desc(wa + k), dx, 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += t[i];
    }
  } else {
    float ta[32], tb[32];
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      float (&t)[32] = (kk & 1) ? tb : ta;
      const unsigned k = 256 * kk;   // two core matrices a k-step
      const uint64_t dx = cm_desc(xa + k);
      wgmma_fence();
      wgmma64(t, cm_desc(wa + 2 * (unsigned)kPartBytes + k), dx, 0);
      wgmma64(t, cm_desc(wa + (unsigned)kPartBytes + k), dx, 1);
      wgmma64(t, cm_desc(wa + k), dx, 1);
      wgmma_commit();
      if (kk > 0) {
        wgmma_wait<1>();
        float (&done)[32] = (kk & 1) ? ta : tb;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += done[i];
      }
    }
    wgmma_wait<0>();
    float (&last)[32] = ((kKSteps - 1) & 1) ? tb : ta;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += last[i];
  }
}

// pre = acc + off0 w97 + off1 w195 + b1 for the fragment entry of board
// `row`, unit j.
__device__ __forceinline__ float pre_act(const Smem& s, float acc, int row,
                                         int j) {
  float pre = fmaf(s.offv[2 * row], s.w97[j], acc);
  pre = fmaf(s.offv[2 * row + 1], s.w195[j], pre);
  return pre + s.b1[j];
}

__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (!signbit(v)) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  }
}

// One step of a reduce-scatter over lanes: the lane and its partner (lane ^
// mask) each keep one half of v[0, 2N), summed, in v[0, N).
template <int N>
__device__ __forceinline__ void halve(float (&v)[16], int upper, int mask) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float send = upper ? v[k] : v[k + N];
    const float recv = __shfl_xor_sync(kFull, send, mask);
    v[k] = (upper ? v[k + N] : v[k]) + recv;
  }
}

// Blocks write the floor of the slots that their share of the rows does not
// keep (logits and masked; a whole row's slots all get its value): 256
// rows' limits at a time into the window's array (free until the window is
// loaded), then the stores.
template <bool kLim>
__device__ void write_floors(const Args& a, const Smem& s, int block,
                             int blocks) {
  const int r0 = (int)((long long)a.rows * block / blocks);
  const int r1 = (int)((long long)a.rows * (block + 1) / blocks);
  for (int c0 = r0; c0 < r1; c0 += kThreads) {
    const int r = c0 + (int)threadIdx.x;
    const int l = r < r1 ? lim_of<false, kLim>(a, r) : a.m;
    s.woff[threadIdx.x] = l == kWhole ? a.m : l;
    __syncthreads();
    const int cnt = min(kThreads, r1 - c0);
    for (int i = 0; i < cnt; ++i) {
      float* orow = a.out + (size_t)(c0 + i) * a.m;
      for (int sl = s.woff[i] + threadIdx.x; sl < a.m; sl += kThreads) {
        orow[sl] = kFloor;
      }
    }
    __syncthreads();
  }
}

// The forward.  kMode kSingle: one unit group a block; kPair: clusters
// of two blocks, rank q with units 128 q .. 128 q + 127; kSplit: block (p,
// q) takes tile range p for units 128 q .. 128 q + 127 and writes the
// group's head partials into a.part (afterstate_finish_kernel ends the
// pass).  kLim: a.lim may be set (the logits epilogue's whole rows, and every
// deep form); false: the masked and min forms, without the whole rows' code.
template <int kMode, bool kBf16, bool kLim>
__global__ void __launch_bounds__(kThreads, 1)
afterstate_eval_kernel(Args a) {
  constexpr bool kRouted_ = kMode == kRoute;
  constexpr bool kPair_ = kMode == kPair;
  constexpr bool kEmit_ = kMode == kEmit || kRouted_;
  constexpr bool kSplit_ = kMode == kSplit || kEmit_;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = kPair_ ? (int)(blockIdx.x & 1)
                          : kSplit_ ? (int)blockIdx.y : 0;
  const int group = kPair_ ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  const int groups = kPair_ ? (int)(gridDim.x >> 1) : (int)gridDim.x;

  if (!kSplit_ && a.epilogue != kMin) {
    write_floors<kLim>(a, s, blockIdx.x, gridDim.x);
  }
  // a routed group's floors are the route kernel's
  if (kEmit_ && !kRouted_ && blockIdx.y == 0) {
    write_floors<kLim>(a, s, blockIdx.x, gridDim.x);
  }
  int t0, t1;
  locate<kRouted_, kLim>(a, s, group, groups, t0, t1);
  if (kEmit_ && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    *a.count = s.sc[10];
    if constexpr (kRouted_) {
      atomicAdd(a.tally, (unsigned long long)s.sc[10]);
    }
  }
  if (t0 >= t1) return;   // both blocks of a pair alike
  const int n_kept = s.sc[10];
  // the first tile's boards fly while W1 is staged
  load_window<kRouted_, kLim>(a, s, s.sc[8], s.sc[9]);
  map_tile<kRouted_, kLim>(a, s, 0, t0 * kTile,
                           min(kTile, n_kept - t0 * kTile), false);
  cp_async_commit();
  stage_weights<kBf16>(a, s, kUnits * rank);
  cp_async_wait<0>();
  __syncthreads();
  // this thread's units 16 warp + g + 8 r: bias, head and off weights
  float b1r[2], whr[2], w97r[2], w195r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = 16 * warp + g + 8 * r;
    b1r[r] = s.b1[j];
    whr[r] = s.wh[j];
    w97r[r] = kBf16 ? 0.0f : s.w97[j];
    w195r[r] = kBf16 ? 0.0f : s.w195[j];
  }
  const float bias = weight<kBf16>(a.bh, 0);
  float* remote_yx = nullptr;
  if constexpr (kPair_) {
    remote_yx = cg::this_cluster().map_shared_rank(s.yx, 1);
  }

  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    decode_tile<kBf16>(a, s, buf, false);
    // the tile's features are in; every thread is done with the previous
    // tile, whose slot the next tile's boards now take
    __syncthreads();
    if (tile + 1 < t1) {
      const int g1 = (tile + 1) * kTile;
      map_tile<kRouted_, kLim>(a, s, buf ^ 1, g1, min(kTile, n_kept - g1),
                               false);
      cp_async_commit();
    }
    float acc[32];
    fc1_tile<false, kBf16>(s, acc);
    if constexpr (kEmit_) {   // kept board 64 tile + b, units of this group
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int b = 8 * i + 2 * t + c;
          if (s.te[buf * kTile + b] < 0) continue;
          float* hrow = a.h1 + ((size_t)tile * kTile + b) * a.ldh;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int u = kUnits * rank + 16 * warp + g + 8 * r;
            float pre = fmaf(s.offv[2 * b], w97r[r], acc[4 * i + 2 * r + c]);
            pre = fmaf(s.offv[2 * b + 1], w195r[r], pre) + b1r[r];
            if (u < a.hidden) hrow[u] = fmaxf(pre, 0.0f);
          }
        }
      }
      if (rank == 0 && threadIdx.x < kTile) {   // a whole row's as ~e
        const int k = buf * kTile + threadIdx.x;
        const int e = s.te[k];
        if (e >= 0) {
          const bool whole = (kRouted_ || kLim) && s.twhole[k];
          a.elem[(size_t)tile * kTile + threadIdx.x] = whole ? ~e : e;
        }
      }
      cp_async_wait<0>();   // as below
      __syncthreads();
      continue;
    }
    // the head over this thread's two units for its 16 boards, then over
    // the warp's 16 units: a reduce-scatter over the 8 lanes of a t (each
    // step keeps half the boards), so lane (g, t) ends with boards
    // 8 i + 2 t + c, i = 4 (g & 1) + 2 ((g >> 1) & 1) + (g >> 2)
    float v[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int b = 8 * i + 2 * t + c;
        const float o0 = kBf16 ? 0.0f : s.offv[2 * b];
        const float o1 = kBf16 ? 0.0f : s.offv[2 * b + 1];
        float part = 0.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float pre;
          if constexpr (kBf16) {   // JAX's roundings: the product, the sum
            pre = bf16r(bf16r(acc[4 * i + 2 * r + c]) + b1r[r]);
          } else {
            pre = fmaf(o0, w97r[r], acc[4 * i + 2 * r + c]);
            pre = fmaf(o1, w195r[r], pre) + b1r[r];
          }
          part = fmaf(whr[r], fmaxf(pre, 0.0f), part);
        }
        v[2 * i + c] = part;
      }
    }
    halve<8>(v, g & 1, 4);
    halve<4>(v, (g >> 1) & 1, 8);
    halve<2>(v, (g >> 2) & 1, 16);
    {
      const int i = 4 * (g & 1) + 2 * ((g >> 1) & 1) + (g >> 2);
      s.ysum[warp * kTile + 8 * i + 2 * t] = v[0];
      s.ysum[warp * kTile + 8 * i + 2 * t + 1] = v[1];
    }
    cp_async_wait<0>();   // the next tile's boards, for the next decode
    __syncthreads();
    float y = 0.0f;
    if (threadIdx.x < kTile) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) y += s.ysum[w * kTile + threadIdx.x];
      if constexpr (kPair_) s.yx[buf * kTile + threadIdx.x] = y;
      if constexpr (kSplit_ && !kEmit_) {
        const int e = s.te[buf * kTile + threadIdx.x];
        if (e >= 0) a.part[(size_t)rank * a.rows * a.m + e] = y;
      }
    }
    if constexpr (kSplit_) continue;
    if constexpr (kPair_) {
      cg::this_cluster().sync();   // both halves' partials are written
      if (threadIdx.x < kTile) y += remote_yx[buf * kTile + threadIdx.x];
    }
    if (rank == 0 && threadIdx.x < kTile) {
      const int k = buf * kTile + threadIdx.x;
      const int e = s.te[k];
      if constexpr (kBf16) {
        y = bf16r(bf16r(y) + bias);
      } else {
        y += bias;
      }
      if (a.epilogue != kMin) {
        if constexpr (kLim) {
          const bool whole = e >= 0 && s.twhole[k] != 0;
          if (e >= 0 && !whole) a.out[e] = a.sign * y;
          write_whole_rows(a.out, a.m, e, whole, a.sign * y);
        } else {
          if (e >= 0) a.out[e] = a.sign * y;
        }
      } else {
        // the tile's boards are in row order: a segmented min over the
        // warp, then one atomic a row and warp
        const int row = s.trow[k];
        float v = e >= 0 ? y : __int_as_float(0x7f800000);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float ov = __shfl_down_sync(kFull, v, o);
          const int orow = __shfl_down_sync(kFull, row, o);
          if (lane + o < 32 && orow == row) v = fminf(v, ov);
        }
        const int prev = __shfl_up_sync(kFull, row, 1);
        if (row >= 0 && (lane == 0 || prev != row)) {
          atomic_min_float(a.out + row, v);
        }
      }
    }
  }
  if constexpr (kPair_) {
    cg::this_cluster().sync();   // rank 1's shared memory outlives the reads
  }
}

// The value of element e past 256 units: the groups' head partials summed
// in group order, then b_head (kBf16: JAX's two roundings).
template <bool kBf16>
__device__ __forceinline__ float split_value(const Args& a, int groups,
                                             size_t e, float bias) {
  const size_t stride = (size_t)a.rows * a.m;
  float y = 0.0f;
  for (int q = 0; q < groups; ++q) y += a.part[q * stride + e];
  return kBf16 ? bf16r(bf16r(y) + bias) : y + bias;
}

// The epilogue past 256 units: logits and masked a thread an element (the
// floor where the row keeps none, slot 0's value in a whole row), the min
// a warp a row (+1e9 where the row keeps none, as the fill and the atomics
// give it below 256 units).
template <bool kBf16>
__global__ void afterstate_finish_kernel(Args a, int groups) {
  const float bias = weight<kBf16>(a.bh, 0);
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a.epilogue != kMin) {
    if (i >= (size_t)a.rows * a.m) return;
    const int r = (int)(i / a.m), sl = (int)(i - (size_t)r * a.m);
    const int l = lim_of(a, r);
    const size_t e = l == kWhole ? (size_t)r * a.m : i;
    a.out[i] = l == kWhole || sl < l
                   ? a.sign * split_value<kBf16>(a, groups, e, bias)
                   : kFloor;
    return;
  }
  const int r = (int)(i >> 5), lane = threadIdx.x & 31;
  if (r >= a.rows) return;   // the whole warp
  const int lim = limit_of(a, r);
  float v = kPosInf;
  for (int sl = lane; sl < lim; sl += 32) {
    v = fminf(v, split_value<kBf16>(a, groups, (size_t)r * a.m + sl, bias));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) a.out[r] = v;
}

// The backward.  Grid (P, ceil(H / 128)): block (p, q) sums the gradient
// of its range of tiles for units 128 q .. min(128 q + 127, H - 1) into
// slab p of part, P slabs of 198 H + 2 H + 1 floats laid out as the flat
// output: dW1 (H, 198), db1 (H), dw_head (H), db_head.  kDeep (a deep
// network's fc1, float32): dpre is csrc/dense.cu's, read from a.dpre by kept
// board in the forward's order; no fc1 product, no head (dw_head and db_head
// come out zero).  kRouted (with kDeep): one group of a routed pass, its
// kept boards in the order of afterstate_route_kernel's layout.
template <bool kBf16, bool kDeep, bool kRouted = false>
__global__ void __launch_bounds__(kThreads, 1)
afterstate_backward_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int u0 = kUnits * blockIdx.y;

  // dW1 of units u0 + 16 warp + g (+ 8) x features 8 nf + 2 t (+ 1)
  float dw[kK / 8][4];
#pragma unroll
  for (int nf = 0; nf < kK / 8; ++nf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dw[nf][i] = 0.0f;
  }
  float gbh = 0.0f;
  for (int i = threadIdx.x; i < 4 * kUnits; i += kThreads) s.gsum[i] = 0.0f;

  int t0, t1;
  locate<kRouted>(a, s, blockIdx.x, gridDim.x, t0, t1);
  if (t0 < t1) {
    const int n_kept = s.sc[10];
    load_window<kRouted>(a, s, s.sc[8], s.sc[9]);
    map_tile<kRouted>(a, s, 0, t0 * kTile, min(kTile, n_kept - t0 * kTile),
                      !kDeep);
    cp_async_commit();
    if constexpr (!kDeep) stage_weights<kBf16>(a, s, u0);
    cp_async_wait<0>();
    __syncthreads();
    // ldmatrix.trans rows of the feature tile: boards 16 kk + 8 ((l >> 3) &
    // 1) + (l & 7) of feature group 2 nb + (l >> 4), lane l
    const unsigned xt = smem_addr(s.x) +
                        (((lane >> 3) & 1) * kKG + (lane >> 4)) * 128 +
                        (lane & 7) * 16;
    for (int tile = t0; tile < t1; ++tile) {
      const int buf = (tile - t0) & 1;
      decode_tile<kBf16>(a, s, buf, !kDeep);
      __syncthreads();   // as in the forward
      if (tile + 1 < t1) {
        const int g1 = (tile + 1) * kTile;
        map_tile<kRouted>(a, s, buf ^ 1, g1, min(kTile, n_kept - g1),
                          !kDeep);
        cp_async_commit();
      }
      if (!kDeep && warp == 0) {   // the tile's sum of d, then the block's
        float v = s.dval[lane] + s.dval[lane + 32];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        gbh += v;
      }
      float acc[32];
      if constexpr (kDeep) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int b = 8 * i + 2 * t + c;
            const bool kept = s.te[buf * kTile + b] >= 0;
            const float* drow = a.dpre + ((size_t)tile * kTile + b) * a.ldh;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int u = u0 + 16 * warp + g + 8 * r;
              acc[4 * i + 2 * r + c] = kept && u < a.hidden ? drow[u] : 0.0f;
            }
          }
        }
      } else {
        fc1_tile<true, kBf16>(s, acc);
      }
      {
        // dpre in place of pre, and the tile's db1, dw_head, dW1[:, 97],
        // dW1[:, 195] of units 16 warp + g + 8 r: this thread's 16 boards,
        // then the 4 lanes of a g in a fixed order, then into the block's
        // sums (kBf16: the off columns are in the tile, so the first two)
        constexpr int kSums = kBf16 ? 2 : 4;
        float sums[4][2] = {};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int b = 8 * i + 2 * t + c;
            const float d = kDeep ? 0.0f : s.dval[b];
            const float o0 = kBf16 ? 0.0f : s.offv[2 * b];
            const float o1 = kBf16 ? 0.0f : s.offv[2 * b + 1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = 16 * warp + g + 8 * r;
              float pre = 0.0f, dp;
              if constexpr (kDeep) {
                dp = acc[4 * i + 2 * r + c];
              } else if constexpr (kBf16) {   // the forward's roundings; dh's
                pre = bf16r(bf16r(acc[4 * i + 2 * r + c]) + s.b1[j]);
                dp = pre > 0.0f ? bf16r(d * s.wh[j]) : 0.0f;
              } else {
                pre = pre_act(s, acc[4 * i + 2 * r + c], b, j);
                dp = pre > 0.0f ? d * s.wh[j] : 0.0f;
              }
              sums[0][r] += dp;
              if constexpr (!kDeep) {
                sums[1][r] = fmaf(d, fmaxf(pre, 0.0f), sums[1][r]);
              }
              if constexpr (!kBf16) {
                sums[2][r] = fmaf(o0, dp, sums[2][r]);
                sums[3][r] = fmaf(o1, dp, sums[3][r]);
              }
              acc[4 * i + 2 * r + c] = dp;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float v = sums[k][r];
            v += __shfl_xor_sync(kFull, v, 1);
            v += __shfl_xor_sync(kFull, v, 2);
            if (t == 0) s.gsum[k * kUnits + 16 * warp + g + 8 * r] += v;
          }
        }
      }
      // boards 16 mt .. 16 mt + 15 are dW1's k-step mt: dpre's fragments
      // of boards 8 (2 mt) .. and 8 (2 mt + 1) .. are its A operand
      // (units x boards) as they stand, in three bf16 parts (kBf16: dpre
      // is a bf16 number, one part)
      constexpr int kNP = kBf16 ? 1 : kParts;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t at[kNP][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // q: (boards 16 mt + 2 t.., unit g), (.., unit g + 8), then the
          // same 8 boards on
          const int base = 4 * (2 * mt + (q >> 1)) + 2 * (q & 1);
          uint32_t lo[kParts], hi[kParts];
          split3(acc[base], lo);
          split3(acc[base + 1], hi);
#pragma unroll
          for (int k = 0; k < kNP; ++k) at[k][q] = lo[k] | (hi[k] << 16);
        }
        // four feature fragments at a time: each part's four products
        // between two that depend, into zeroed fragments, then into dw
        // (kBf16: the one part's products straight into dw)
#pragma unroll
        for (int nb = 0; nb < kK / 16; nb += 2) {
          constexpr int kLast = kK / 16 - 1;
          uint32_t xb[2][4];
          const unsigned at_k = xt + (2 * mt * kKG + 2 * nb) * 128;
          ldsm_x4_trans(xb[0], at_k);
          if (nb < kLast) ldsm_x4_trans(xb[1], at_k + 2 * 128);
          const int nq = nb < kLast ? 4 : 2;
          if constexpr (kBf16) {
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              if (f < nq) {
                mma(dw[2 * nb + f], at[0], xb[f >> 1][2 * (f & 1)],
                    xb[f >> 1][2 * (f & 1) + 1]);
              }
            }
          } else {
            float tq[4][4] = {};
#pragma unroll
            for (int k = kParts - 1; k >= 0; --k) {
#pragma unroll
              for (int f = 0; f < 4; ++f) {
                if (f < nq) {
                  mma(tq[f], at[k], xb[f >> 1][2 * (f & 1)],
                      xb[f >> 1][2 * (f & 1) + 1]);
                }
              }
            }
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              if (f < nq) {
#pragma unroll
                for (int i = 0; i < 4; ++i) dw[2 * nb + f][i] += tq[f][i];
              }
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // the tile's features are read
    }
  }
  __syncthreads();

  // this block's partial sums into its slab
  const size_t slab_floats = (size_t)kFeatures * a.hidden + 2 * a.hidden + 1;
  float* slab = a.out + (size_t)blockIdx.x * slab_floats;
#pragma unroll
  for (int nf = 0; nf < kK / 8; ++nf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int f = 8 * nf + 2 * t + c;
      if (f < kFeatures && (kBf16 || (f != kOff0 && f != kOff1))) {
        const int j = u0 + 16 * warp + g;
        if (j < a.hidden) slab[(size_t)j * kFeatures + f] = dw[nf][c];
        if (j + 8 < a.hidden) {
          slab[(size_t)(j + 8) * kFeatures + f] = dw[nf][2 + c];
        }
      }
    }
  }
  float* tail = slab + (size_t)kFeatures * a.hidden;
  if (threadIdx.x < kUnits && u0 + (int)threadIdx.x < a.hidden) {
    const int j = threadIdx.x;
    tail[u0 + j] = s.gsum[j];
    tail[a.hidden + u0 + j] = s.gsum[kUnits + j];
    if constexpr (!kBf16) {
      slab[(size_t)(u0 + j) * kFeatures + kOff0] = s.gsum[2 * kUnits + j];
      slab[(size_t)(u0 + j) * kFeatures + kOff1] = s.gsum[3 * kUnits + j];
    }
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) tail[2 * a.hidden] = gbh;
}

// out[e] = the sum of the blocks' partials of entry e, in block order
// (kBf16: rounded to bf16 once, as a float).
template <bool kBf16>
__global__ void afterstate_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, int blocks,
                                         int entries) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  float s = 0.0f;
  for (int p = 0; p < blocks; ++p) s += part[(size_t)p * entries + e];
  out[e] = kBf16 ? bf16r(s) : s;
}

// An empty min's +1e9 in every row, before the forward's atomics.
__global__ void afterstate_fill_kernel(float* __restrict__ out, int n,
                                       float v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = v;
}

// The 13 words of the board at b (aligned: b is 4-byte aligned, read as
// words; else byte by byte).
__device__ __forceinline__ void load_board(const int8_t* b, int aligned,
                                           uint32_t (&v)[13]) {
  if (aligned) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(b);
#pragma unroll
    for (int k = 0; k < 13; ++k) v[k] = w[k];
  } else {
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      v[k] = (uint32_t)(uint8_t)b[4 * k] |
             (uint32_t)(uint8_t)b[4 * k + 1] << 8 |
             (uint32_t)(uint8_t)b[4 * k + 2] << 16 |
             (uint32_t)(uint8_t)b[4 * k + 3] << 24;
    }
  }
}

// Whether the canonical board of words v is a race: the mover's rearmost
// checker past every opponent checker, a checker on the bar rearmost for its
// side (the mover's at point -1, the opponent's at 24), a side with no
// checker left meeting none (core/board.py::is_race).
__device__ __forceinline__ bool board_is_race(const uint32_t (&v)[13]) {
  unsigned mine = 0u, theirs = 0u;   // bit i: point i holds a checker
#pragma unroll
  for (int i = 0; i < 48; ++i) {
    const unsigned occ = (int8_t)(v[i >> 2] >> (8 * (i & 3))) > 0;
    if (i < 24) {
      mine |= occ << i;
    } else {
      theirs |= occ << (i - 24);
    }
  }
  const int my_bar = (int8_t)v[12];
  const int opp_bar = (int8_t)(v[12] >> 8);
  const int my_min = my_bar > 0 ? -1 : mine ? __ffs(mine) - 1 : 99;
  const int opp_max = opp_bar > 0 ? 24 : theirs ? 31 - __clz(theirs) : -99;
  return my_min > opp_max;
}

// Whether the words v equal ref.
__device__ __forceinline__ bool same_board(const uint32_t (&v)[13],
                                           const uint32_t (&ref)[13]) {
  bool same = true;
#pragma unroll
  for (int k = 0; k < 13; ++k) same &= v[k] == ref[k];
  return same;
}

constexpr int kRowWarps = 8;   // rows (warps) a block of the row kernels

// Each row's entry of lim under the logits epilogue: kWhole where n <= 0
// and all m boards equal slot 0, byte for byte, else its slot limit (m where
// n <= 0); each whole row adds one to tally.  A warp a row, 32 boards at a
// time, stopping at the first board that differs; rows with n > 0 read n
// alone.
__global__ void __launch_bounds__(32 * kRowWarps)
afterstate_collapse_kernel(const int8_t* __restrict__ boards,
                           const int32_t* __restrict__ n,
                           int* __restrict__ lim,
                           unsigned long long* __restrict__ tally, int rows,
                           int m, int aligned) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;   // the whole warp
  const int nr = n[r];
  bool whole = nr <= 0 && m > 0;
  if (whole) {
    const int8_t* row = boards + (size_t)r * m * kBoard;
    uint32_t ref[13];
    load_board(row, aligned, ref);
    for (int s0 = 0; s0 < m && whole; s0 += 32) {
      const int sl = s0 + lane;
      bool same = true;
      if (sl < m) {
        uint32_t v[13];
        load_board(row + (size_t)sl * kBoard, aligned, v);
        same = same_board(v, ref);
      }
      whole = __all_sync(kFull, same);
    }
  }
  if (lane == 0) {
    lim[r] = whole ? kWhole : row_limit(nr, m, kLogits);
    if (whole) atomicAdd(tally, 1ull);
  }
}

// Each whole row's (lim kWhole) m entries of grad summed into wgrad[r], the
// backward's cotangent of its one board: a warp a row (warp_row_sum, a
// fixed order); other rows read lim alone.
__global__ void __launch_bounds__(32 * kRowWarps)
afterstate_whole_grad_kernel(const float* __restrict__ grad,
                             const int* __restrict__ lim,
                             float* __restrict__ wgrad, int rows, int m) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows || lim[r] != kWhole) return;   // the whole warp
  const float sum = warp_row_sum(grad + (size_t)r * m, m);
  if (lane == 0) wgrad[r] = sum;
}

// A routed pass's two groups: a warp a row writes the floor of each slot
// the epilogue does not keep, decides each kept board's class from its
// bytes (32 slots at a time, in slot order) and lays the kept slots of
// each class out in slot order: class c (0 contact, 1 race) of row r at
// slots[c rows m + r m ..], their number at lim[c rows + r].  Under the
// logits epilogue a row with n <= 0 whose boards all equal slot 0 (compared
// as they are read for their class) is whole: lim kWhole for slot 0's class,
// 0 for the other, and one added to tally.
__global__ void __launch_bounds__(32 * kRowWarps)
afterstate_route_kernel(const int8_t* __restrict__ boards,
                        const int32_t* __restrict__ n, float* __restrict__ out,
                        int* __restrict__ lim, int* __restrict__ slots,
                        unsigned long long* __restrict__ tally, int rows,
                        int m, int epilogue, int aligned) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;   // the whole warp
  const int nr = n[r];
  const int limit = row_limit(nr, m, epilogue);
  float* orow = out + (size_t)r * m;
  for (int sl = limit + lane; sl < m; sl += 32) orow[sl] = kFloor;
  int* contact = slots + (size_t)r * m;
  int* race = slots + ((size_t)rows + r) * m;
  const int8_t* row = boards + (size_t)r * m * kBoard;
  const unsigned below = (1u << lane) - 1u;
  // whether the row may be whole (the same for the warp), and slot 0's words
  const bool may_be_whole = epilogue == kLogits && nr <= 0 && m > 0;
  uint32_t ref[13] = {};
  if (may_be_whole) load_board(row, aligned, ref);
  bool same = true;
  int n_contact = 0, n_race = 0;
  for (int s0 = 0; s0 < limit; s0 += 32) {   // the same trips for the warp
    const int sl = s0 + lane;
    const bool live = sl < limit;
    bool is_race = false;
    if (live) {
      uint32_t v[13];
      load_board(row + (size_t)sl * kBoard, aligned, v);
      is_race = board_is_race(v);
      if (may_be_whole) same &= same_board(v, ref);
    }
    const unsigned rmask = __ballot_sync(kFull, is_race);
    const unsigned cmask = __ballot_sync(kFull, live && !is_race);
    if (is_race) {
      race[n_race + __popc(rmask & below)] = sl;
    } else if (live) {
      contact[n_contact + __popc(cmask & below)] = sl;
    }
    n_race += __popc(rmask);
    n_contact += __popc(cmask);
  }
  const bool whole = __all_sync(kFull, same) && may_be_whole;
  if (lane == 0) {
    if (whole) {   // every board of slot 0's class, slot 0 first
      lim[n_race > 0 ? rows + r : r] = kWhole;
      lim[n_race > 0 ? r : rows + r] = 0;
      atomicAdd(tally, 1ull);
    } else {
      lim[r] = n_contact;
      lim[rows + r] = n_race;
    }
  }
}

// What the launches cache (the >48 KB opt-in, the resident blocks) is the
// current card's, so it is kept for each card apart.
constexpr int kMaxDevices = 64;
constexpr int kMaxGroups = 65535;   // unit groups: the grid's y extent

// The current card's index, or -1.
int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return -1;
  }
  return dev;
}

// Resident groups of the forward (blocks, or pairs of blocks) on the card.
template <int kMode, bool kBf16, bool kLim>
int forward_groups(int dev) {
  static int n[kMaxDevices] = {};  // 0: not read yet (before any capture)
  if (n[dev] == 0) {
    auto* kernel = afterstate_eval_kernel<kMode, kBf16, kLim>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    int got = 0;
    if (err == cudaSuccess && kMode == kPair) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 2;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(2);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = kSmem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&got, kernel, &cfg);
    } else if (err == cudaSuccess) {
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, kSmem);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      }
      got = per_sm * sms;
    }
    if (err != cudaSuccess) return -(int)err;
    if (got < 1) return -(int)cudaErrorInvalidConfiguration;
    n[dev] = got;
  }
  return n[dev];
}

// H <= 256: one launch (after the min's fill), one block or a pair a range
// of tiles.
template <int kMode, bool kBf16, bool kLim>
int launch_forward(const Args& a, cudaStream_t stream) {
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int resident = forward_groups<kMode, kBf16, kLim>(dev);
  if (resident < 0) return -resident;
  if (a.epilogue == kMin && a.rows > 0) {
    afterstate_fill_kernel<<<(a.rows + 255) / 256, 256, 0, stream>>>(
        a.out, a.rows, kPosInf);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long boards = (long long)a.rows * a.m;
  if (boards == 0) return (int)cudaGetLastError();
  const int groups = (int)std::min<long long>((boards + kTile - 1) / kTile,
                                              resident);
  if (kMode == kSingle) {
    afterstate_eval_kernel<kSingle, kBf16, kLim>
        <<<groups, kThreads, kSmem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2 * groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, afterstate_eval_kernel<kPair, kBf16, kLim>,
                         a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// H > 256: tile ranges x unit groups (about one wave), then the finish.
template <bool kBf16, bool kLim>
int launch_split(const Args& a, int unit_groups, cudaStream_t stream) {
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int resident = forward_groups<kSplit, kBf16, kLim>(dev);
  if (resident < 0) return -resident;
  const long long boards = (long long)a.rows * a.m;
  if (boards > 0) {
    const int ranges = (int)std::min<long long>(
        (boards + kTile - 1) / kTile, std::max(resident / unit_groups, 1));
    afterstate_eval_kernel<kSplit, kBf16, kLim>
        <<<dim3(ranges, unit_groups), kThreads, kSmem, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long threads = a.epilogue == kMin ? 32LL * a.rows : boards;
  if (threads > 0) {
    afterstate_finish_kernel<kBf16>
        <<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
            a, unit_groups);
  }
  return (int)cudaGetLastError();
}

// A deep network's fc1 (kEmit): the floors, then tile ranges x unit groups
// (about one wave); a zero count where there is no board.  kRoute: one group
// of a routed pass, whose floors are the route kernel's.
template <int kMode>
int launch_emit(const Args& a, int unit_groups, cudaStream_t stream) {
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int resident = forward_groups<kMode, false, true>(dev);
  if (resident < 0) return -resident;
  const long long boards = (long long)a.rows * a.m;
  if (boards == 0) {
    return (int)cudaMemsetAsync(a.count, 0, sizeof(int), stream);
  }
  const int ranges = (int)std::min<long long>(
      (boards + kTile - 1) / kTile, std::max(resident / unit_groups, 1));
  afterstate_eval_kernel<kMode, false, true>
      <<<dim3(ranges, unit_groups), kThreads, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* boards, const void* mover, const void* n,
               const void* lim, const void* w1, const void* b1,
               const void* wh, const void* bh, const void* grad, void* out,
               void* part, int rows, int m, int hidden, int opponent,
               int epilogue, float sign) {
  Args a{};
  a.boards = (const int8_t*)boards;
  a.mover = (const int32_t*)mover;
  a.n = (const int32_t*)n;
  a.lim = (const int*)lim;
  a.w1 = w1;
  a.b1 = b1;
  a.wh = wh;
  a.bh = bh;
  a.grad = (const float*)grad;
  a.out = (float*)out;
  a.part = (float*)part;
  a.rows = rows;
  a.m = m;
  a.hidden = hidden;
  a.opponent = opponent != 0;
  a.epilogue = epilogue;
  a.sign = sign;
  a.aligned = ((uintptr_t)boards & 3) == 0;
  return a;
}

// The >48 KB opt-in of the backward, before any capture.
template <bool kBf16, bool kDeep, bool kRouted>
int backward_opt_in(int dev) {
  static bool opted[kMaxDevices] = {};
  if (!opted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        afterstate_backward_kernel<kBf16, kDeep, kRouted>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  return 0;
}

template <bool kBf16, bool kDeep = false, bool kRouted = false>
int launch_backward(const Args& a, const float* scratch, float* dparams,
                    int blocks, int unit_groups, cudaStream_t stream) {
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  const int opt = backward_opt_in<kBf16, kDeep, kRouted>(dev);
  if (opt != 0) return opt;
  if (blocks > 0) {
    afterstate_backward_kernel<kBf16, kDeep, kRouted>
        <<<dim3(blocks, unit_groups), kThreads, kSmem, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int entries = kFeatures * a.hidden + 2 * a.hidden + 1;
  afterstate_reduce_kernel<kBf16><<<(entries + 255) / 256, 256, 0, stream>>>(
      scratch, dparams, blocks, entries);
  return (int)cudaGetLastError();
}

// The forward's launch for the width and dtype: one block, a pair, or unit
// groups and the finish (kLim: with lim, the logits epilogue's).
template <bool kLim>
int forward_form(const Args& a, int hidden, int dtype, int unit_groups,
                 cudaStream_t st) {
  if (hidden <= kUnits) {
    return dtype ? launch_forward<kSingle, true, kLim>(a, st)
                 : launch_forward<kSingle, false, kLim>(a, st);
  }
  if (hidden <= 2 * kUnits) {
    return dtype ? launch_forward<kPair, true, kLim>(a, st)
                 : launch_forward<kPair, false, kLim>(a, st);
  }
  return dtype ? launch_split<true, kLim>(a, unit_groups, st)
               : launch_split<false, kLim>(a, unit_groups, st);
}

}  // namespace

// Each row's entry of lim (rows) int32 under the logits epilogue: kWhole (-1)
// where n <= 0 and the row's m boards all equal slot 0, byte for byte, else
// its kept boards; tally (one unsigned 64-bit int) gets the whole rows
// added.  The forms below take this lim (logits only; null: none whole).
extern "C" int afterstate_collapse_launch(const void* boards, const void* n,
                                          void* lim, void* tally, int rows,
                                          int m, void* stream) {
  if (rows < 0 || m < 0 || tally == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaGetLastError();   // lim may be null
  if (lim == nullptr) return (int)cudaErrorInvalidValue;
  afterstate_collapse_kernel<<<(rows + kRowWarps - 1) / kRowWarps,
                               32 * kRowWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)boards, (const int32_t*)n, (int*)lim,
      (unsigned long long*)tally, rows, m, ((uintptr_t)boards & 3) == 0);
  return (int)cudaGetLastError();
}

// The forward pass.  boards (rows, m, 52) int8, mover and n (rows,) int32,
// lim (rows) int32 afterstate_collapse_launch's (logits) or null, w1
// (hidden, 198), b1 (hidden), wh (1, hidden), bh (1), float32 (dtype 0) or
// bf16 (dtype 1); out (rows, m) float32, or (rows) for the min epilogue
// (2).  Any hidden >= 1 (at most 65,535 groups of 128); past 256 units
// scratch holds at least ceil(hidden / 128) rows m floats
// (ops/afterstate.py::forward_scratch_floats).  epilogue 0 logits, 1
// masked, 2 min.
extern "C" int afterstate_eval_launch(const void* boards, const void* mover,
                                      const void* n, const void* lim,
                                      const void* w1, const void* b1,
                                      const void* wh, const void* bh,
                                      void* out, void* scratch,
                                      long long scratch_floats, int rows,
                                      int m, int hidden, int opponent,
                                      int epilogue, float sign, int dtype,
                                      void* stream) {
  const int unit_groups = (hidden + kUnits - 1) / kUnits;
  if (rows < 0 || m < 0 || hidden < 1 || unit_groups > kMaxGroups ||
      epilogue < kLogits || epilogue > kMin || (dtype != 0 && dtype != 1) ||
      (lim != nullptr && epilogue != kLogits)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = make_args(boards, mover, n, lim, w1, b1, wh, bh, nullptr,
                           out, scratch, rows, m, hidden, opponent, epilogue,
                           sign);
  const auto st = (cudaStream_t)stream;
  if (hidden > 2 * kUnits &&
      scratch_floats < (long long)unit_groups * rows * m) {
    return (int)cudaErrorInvalidValue;
  }
  return lim != nullptr
             ? forward_form<true>(a, hidden, dtype, unit_groups, st)
             : forward_form<false>(a, hidden, dtype, unit_groups, st);
}

// The backward pass: grad (rows, m) float32 is the output's gradient (the
// logits or masked epilogue); lim as the forward's, and with it wgrad (rows)
// float32 scratch for the whole rows' summed cotangents; dparams (198 hidden
// + 2 hidden + 1) float32 gets dW1 (hidden, 198), db1, dw_head, db_head
// (dtype 1: each a bf16 number); blocks is
// ops/afterstate.py::backward_blocks of the shapes and scratch holds at
// least blocks (198 hidden + 2 hidden + 1) floats.  bh is not read.
extern "C" int afterstate_backward_launch(
    const void* boards, const void* mover, const void* n, const void* lim,
    void* wgrad, const void* w1, const void* b1, const void* wh,
    const void* bh, const void* grad, void* scratch, long long scratch_floats,
    void* dparams, int blocks, int rows, int m, int hidden, int opponent,
    int epilogue, float sign, int dtype, void* stream) {
  const int unit_groups = (hidden + kUnits - 1) / kUnits;
  const long long slab = (long long)kFeatures * hidden + 2LL * hidden + 1;
  if (rows < 0 || m < 0 || hidden < 1 || unit_groups > kMaxGroups ||
      blocks < 0 || (blocks == 0 && (long long)rows * m > 0) ||
      scratch_floats < blocks * slab ||
      (epilogue != kLogits && epilogue != kMasked) ||
      (dtype != 0 && dtype != 1) ||
      (lim != nullptr && epilogue != kLogits) ||
      (lim != nullptr && rows > 0 && wgrad == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = make_args(boards, mover, n, lim, w1, b1, wh, bh, grad, scratch,
                     nullptr, rows, m, hidden, opponent, epilogue, sign);
  a.wgrad = (const float*)wgrad;
  const auto st = (cudaStream_t)stream;
  if (lim != nullptr && rows > 0) {
    afterstate_whole_grad_kernel<<<(rows + kRowWarps - 1) / kRowWarps,
                                   32 * kRowWarps, 0, st>>>(
        (const float*)grad, (const int*)lim, (float*)wgrad, rows, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return dtype ? launch_backward<true>(a, (const float*)scratch,
                                       (float*)dparams, blocks, unit_groups,
                                       st)
               : launch_backward<false>(a, (const float*)scratch,
                                        (float*)dparams, blocks, unit_groups,
                                        st);
}

// A deep network's fc1, float32: out (rows, m) gets the floor of every slot
// the epilogue (0 logits, 1 masked) does not keep; h1 (at least the kept
// boards' number of rows, ldh >= hidden floats apart, a multiple of 4) the
// post-ReLU fc1 of each kept board in the kernels' global order, elem its
// element r m + s (~(r m) for a whole row's), count (one int) their number;
// lim as afterstate_eval_launch's.  csrc/dense.cu runs the rest.
extern "C" int afterstate_emit_launch(const void* boards, const void* mover,
                                      const void* n, const void* lim,
                                      const void* w1, const void* b1,
                                      void* out, void* h1, int ldh,
                                      void* elem, void* count, int rows,
                                      int m, int hidden, int opponent,
                                      int epilogue, void* stream) {
  const int unit_groups = (hidden + kUnits - 1) / kUnits;
  if (rows < 0 || m < 0 || hidden < 1 || unit_groups > kMaxGroups ||
      ldh < hidden || ldh % 4 != 0 ||
      (epilogue != kLogits && epilogue != kMasked) ||
      (lim != nullptr && epilogue != kLogits)) {
    return (int)cudaErrorInvalidValue;
  }
  // the head's pointers are staged but not read: b1 stands in for them
  Args a = make_args(boards, mover, n, lim, w1, b1, b1, b1, nullptr, out,
                     nullptr, rows, m, hidden, opponent, epilogue, 1.0f);
  a.h1 = (float*)h1;
  a.elem = (int*)elem;
  a.count = (int*)count;
  a.ldh = ldh;
  return launch_emit<kEmit>(a, unit_groups, (cudaStream_t)stream);
}

// A deep network's fc1 backward, float32: dpre (kept boards, ldh floats
// apart) is fc1's pre-activation gradient by kept board in the forward's
// order (csrc/dense.cu's); lim the forward's; dparams, blocks and scratch as
// in afterstate_backward_launch, whose dw_head and db_head come out zero.
extern "C" int afterstate_backward_deep_launch(
    const void* boards, const void* mover, const void* n, const void* lim,
    const void* dpre, int ldh, void* scratch, long long scratch_floats,
    void* dparams, int blocks, int rows, int m, int hidden, int opponent,
    int epilogue, void* stream) {
  const int unit_groups = (hidden + kUnits - 1) / kUnits;
  const long long slab = (long long)kFeatures * hidden + 2LL * hidden + 1;
  if (rows < 0 || m < 0 || hidden < 1 || unit_groups > kMaxGroups ||
      ldh < hidden || blocks < 0 ||
      (blocks == 0 && (long long)rows * m > 0) ||
      scratch_floats < blocks * slab ||
      (epilogue != kLogits && epilogue != kMasked) ||
      (lim != nullptr && epilogue != kLogits)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = make_args(boards, mover, n, lim, nullptr, nullptr, nullptr,
                     nullptr, nullptr, scratch, nullptr, rows, m, hidden,
                     opponent, epilogue, 1.0f);
  a.dpre = (const float*)dpre;
  a.ldh = ldh;
  return launch_backward<false, true>(a, (const float*)scratch,
                                      (float*)dparams, blocks, unit_groups,
                                      (cudaStream_t)stream);
}

// A routed pass's layout: boards (rows, m, 52) int8, n (rows) int32 and the
// epilogue (0 logits, 1 masked) as the emit's; out (rows, m) float32 gets
// the floor of every slot not kept; lim (2, rows) int32 each row's entry of
// each class (0 contact, 1 race): its kept boards of the class, or kWhole
// (-1) for a whole row's class, slots (2, rows m) int32 their slots in slot
// order (afterstate_route_kernel); tally (one unsigned 64-bit int) gets the
// whole rows added.
extern "C" int afterstate_route_launch(const void* boards, const void* n,
                                       void* out, void* lim, void* slots,
                                       void* tally, int rows, int m,
                                       int epilogue, void* stream) {
  if (rows < 0 || m < 0 || tally == nullptr ||
      (epilogue != kLogits && epilogue != kMasked)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaGetLastError();
  afterstate_route_kernel<<<(rows + kRowWarps - 1) / kRowWarps,
                            32 * kRowWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)boards, (const int32_t*)n, (float*)out, (int*)lim,
      (int*)slots, (unsigned long long*)tally, rows, m, epilogue,
      ((uintptr_t)boards & 3) == 0);
  return (int)cudaGetLastError();
}

// fc1 of one group of a routed pass, float32: lim (rows) and slots (rows m)
// are afterstate_route_launch's of the group's class; h1, ldh, elem (a whole
// row's board as ~(r m)) and count as afterstate_emit_launch's, over the
// group's kept boards in its order; tally (one unsigned 64-bit int) gets the
// count added.
extern "C" int afterstate_emit_routed_launch(
    const void* boards, const void* mover, const void* lim, const void* slots,
    const void* w1, const void* b1, void* h1, int ldh, void* elem,
    void* count, void* tally, int rows, int m, int hidden, int opponent,
    void* stream) {
  const int unit_groups = (hidden + kUnits - 1) / kUnits;
  if (rows < 0 || m < 0 || hidden < 1 || unit_groups > kMaxGroups ||
      ldh < hidden || ldh % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = make_args(boards, mover, nullptr, lim, w1, b1, b1, b1, nullptr,
                     nullptr, nullptr, rows, m, hidden, opponent, kMasked,
                     1.0f);
  a.rslot = (const int*)slots;
  a.tally = (unsigned long long*)tally;
  a.h1 = (float*)h1;
  a.elem = (int*)elem;
  a.count = (int*)count;
  a.ldh = ldh;
  return launch_emit<kRoute>(a, unit_groups, (cudaStream_t)stream);
}

// fc1's backward of one group of a routed pass, float32: lim and slots as
// afterstate_emit_routed_launch's, dpre by kept board in its order; the
// rest as afterstate_backward_deep_launch's.
extern "C" int afterstate_backward_deep_routed_launch(
    const void* boards, const void* mover, const void* lim, const void* slots,
    const void* dpre, int ldh, void* scratch, long long scratch_floats,
    void* dparams, int blocks, int rows, int m, int hidden, int opponent,
    void* stream) {
  const int unit_groups = (hidden + kUnits - 1) / kUnits;
  const long long slab = (long long)kFeatures * hidden + 2LL * hidden + 1;
  if (rows < 0 || m < 0 || hidden < 1 || unit_groups > kMaxGroups ||
      ldh < hidden || blocks < 0 ||
      (blocks == 0 && (long long)rows * m > 0) ||
      scratch_floats < blocks * slab) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = make_args(boards, mover, nullptr, lim, nullptr, nullptr, nullptr,
                     nullptr, nullptr, scratch, nullptr, rows, m, hidden,
                     opponent, kMasked, 1.0f);
  a.rslot = (const int*)slots;
  a.dpre = (const float*)dpre;
  a.ldh = ldh;
  return launch_backward<false, true, true>(a, (const float*)scratch,
                                            (float*)dparams, blocks,
                                            unit_groups,
                                            (cudaStream_t)stream);
}
