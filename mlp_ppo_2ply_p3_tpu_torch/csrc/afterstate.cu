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
// (_masked_min_values), all in mlp_ppo_2ply_p3_tpu/.
//
// Arithmetic: float32 with float32 accumulation, no tensor cores.  The
// features are built bit for bit as core/features.py builds them (small
// integers, halves, and off * float32(1/15) by __fmul_rn); only the order of
// the sums of fc1 and the head differs from torch's, so the results are held
// to a tolerance.  nvcc contracts a * b + c into an FMA here, which the
// tolerance allows.  No float atomics: every sum runs in an order fixed by
// the inputs' shapes, so a launch gives the same bits every time.
//
// What bounds it on this card.  A board is 52 bytes, so bytes set a bound of
// 58.7 MB (boards and scores) = 0.018 ms a rollout step at B=4096, M=256;
// the dense fc1 is 2 x 198 x H flops a board, 53 GFLOP = 0.79 ms a step at
// the float32 rate.  Operations bind, and the design cuts them instead:
//
// - Only the boards the epilogue keeps are evaluated (slot < n; every slot
//   of a logits row with n <= 0); the rest are a store of the floor.  A
//   position has about 20-30 moves of M = 256 slots.
// - fc1 is a sum of W1 columns over the board's non-zero features: a point
//   holding c checkers sets min(c, 3) + [c > 3] <= c of them, so a board has
//   at most 35 of 198 (15 checkers a side, bar and off, the turn).  A warp
//   ballots the board's non-zero bytes and walks them; each sets its
//   features' columns, at most a fifth of the dense products.
// - Forward: W1 sits transposed in shared memory (198 x (H + 4) floats: 104
//   KB at H=128, 2 blocks of 512 threads an SM; 206 KB at H=256, one block),
//   one warp per board, lane l holding hidden units 128 g + 4 l + t, so a
//   feature's column is one conflict-free 16-byte load a lane.  The head is
//   a warp shuffle sum.  Persistent blocks walk the rows, one row at a time,
//   its kept slots dealt out to the 16 warps in turn (the min: each warp's,
//   then the block's), so the 101-206 KB of W1 are staged once a block and a
//   row's boards, 20-30 or all 256 of a row without a move, spread over the
//   block.  (Work items of 32 slots dealt out in row order, the first
//   design, gave every slot-0 item to one warp in eight: 0.466 ms at a
//   rollout step on an H100.)
// - Backward: dW1 (H x 198), db1, dw_head and db_head summed over R x M
//   boards (2,097,152 at a full-width minibatch).  A block takes rows p,
//   p + P, ... and a tile of 32 hidden units (grid P x H/32); it lists the
//   kept boards of its rows in shared memory, 256 at a time, recomputes
//   each one's pre-activations for its tile (one warp a board, lane =
//   unit), and then every thread adds the list's dpre x feature products
//   into the entries of dW1 it owns (lane = unit, warp = 3 of the 48
//   points and one scalar feature), in list order.  A block's partial
//   gradient (198 x H + 2 H + 1 floats; 101 KB at H=128, 203 KB at H=256)
//   goes to device memory and a second kernel sums the P partials of each
//   entry in block order.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kBoard = 52;
constexpr int kFeatures = 198;
constexpr int kPerPlayer = 98;   // 24 points x 4, bar, off
constexpr float kInvCheckers = 0x1.111112p-4f;  // float32(1 / 15)
constexpr float kFloor = -1e9f;
constexpr float kPosInf = 1e9f;
constexpr int kLogits = 0, kMasked = 1, kMin = 2;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kFwdThreads = 512;
constexpr int kFwdWarps = kFwdThreads / 32;

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kTile = 32;        // hidden units a backward block
constexpr int kTilePitch = kTile + 1;
constexpr int kList = 256;       // kept boards staged at most
constexpr int kPointsPerWarp = 48 / kBwdWarps;
constexpr int kMaxBlocks = 264;  // backward: row blocks at most

// The slots [0, limit) of a row that its epilogue keeps.
__device__ __forceinline__ int row_limit(int n, int m, int epilogue) {
  if (epilogue == kLogits && n <= 0) return m;
  return n < 0 ? 0 : (n > m ? m : n);
}

// add(f, v) for each non-zero feature that byte k (count c != 0) of a
// canonical board sets, for the frame flip = (mover != 0) ^ opponent: the
// byte's absolute point a (player a / 24, point a % 24), or player q's bar or
// off.  The values are core/features.py's, bit for bit.
template <typename Add>
__device__ __forceinline__ void byte_features(int k, int c, int flip,
                                              Add&& add) {
  if (k < 48) {
    if (c <= 0) return;
    const int a = flip ? 47 - k : k;
    const int q = a >= 24;
    const int base = q * kPerPlayer + 4 * (a - 24 * q);
    add(base, 1.0f);
    if (c >= 2) add(base + 1, 1.0f);
    if (c >= 3) add(base + 2, 1.0f);
    if (c > 3) add(base + 3, (float)(c - 3) * 0.5f);
  } else if (k < 50) {
    add(((k - 48) ^ flip) * kPerPlayer + 96, (float)c * 0.5f);
  } else {
    add(((k - 50) ^ flip) * kPerPlayer + 97,
        __fmul_rn((float)c, kInvCheckers));
  }
}

// The turn one-hot's feature of a mover (none for a mover outside {0, 1},
// as core/features.py's (t == 0, t == 1)).
__device__ __forceinline__ int hot_feature(int mover) {
  return mover == 0 ? 196 : (mover == 1 ? 197 : -1);
}

// A warp walks one board's non-zero bytes (lanes hold bytes lane and
// 32 + lane) and calls add for each feature, the one-hot first.
template <typename Add>
__device__ __forceinline__ void board_features(int c_lo, int c_hi, int flip,
                                               int hot, Add&& add) {
  unsigned lo = __ballot_sync(kFull, c_lo != 0);
  unsigned hi = __ballot_sync(kFull, c_hi != 0);
  if (hot >= 0) add(hot, 1.0f);
  while (lo) {
    const int k = __ffs(lo) - 1;
    lo &= lo - 1;
    byte_features(k, __shfl_sync(kFull, c_lo, k), flip, add);
  }
  while (hi) {
    const int k = __ffs(hi) - 1;
    hi &= hi - 1;
    byte_features(32 + k, __shfl_sync(kFull, c_hi, k), flip, add);
  }
}

template <int H>
__global__ void __launch_bounds__(kFwdThreads, H == 128 ? 2 : 1)
afterstate_eval_kernel(const int8_t* __restrict__ boards,
                       const int32_t* __restrict__ mover,
                       const int32_t* __restrict__ n_valid,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ wh,
                       const float* __restrict__ bh, float* __restrict__ out,
                       int rows, int m, int opponent, int epilogue,
                       float sign) {
  constexpr int kPitch = H + 4;   // 16-byte rows, 4-way conflicts at staging
  constexpr int kUnits = H / 32;  // a lane's: 128 g + 4 lane + t
  extern __shared__ __align__(16) float w1t[];  // [198][kPitch], W1^T
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < H; j += kFwdWarps) {
    for (int f = lane; f < kFeatures; f += 32) {
      w1t[f * kPitch + j] = w1[j * kFeatures + f];
    }
  }
  float b1r[kUnits], whr[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int j = 128 * (u / 4) + 4 * lane + (u % 4);
    b1r[u] = b1[j];
    whr[u] = wh[j];
  }
  const float bias = bh[0];
  __syncthreads();

  __shared__ float warp_min[kFwdWarps];
  // one row at a time, its kept slots dealt out to the warps in turn
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int limit = row_limit(n_valid[r], m, epilogue);
    const int mv = mover[r];
    const int flip = (mv != 0) ^ opponent;
    const int hot = hot_feature(mv);
    float* orow = out + (size_t)r * m;
    if (epilogue != kMin) {
      for (int s = limit + threadIdx.x; s < m; s += kFwdThreads) {
        orow[s] = kFloor;
      }
    }
    const int8_t* b = boards + ((size_t)r * m + warp) * kBoard;
    int c_lo = 0, c_hi = 0;
    if (warp < limit) {
      c_lo = b[lane];
      c_hi = lane < kBoard - 32 ? b[32 + lane] : 0;
    }
    float best = kPosInf;
    for (int s = warp; s < limit; s += kFwdWarps) {
      // the next board's bytes, loaded while this one is evaluated
      int n_lo = 0, n_hi = 0;
      if (s + kFwdWarps < limit) {
        n_lo = b[kFwdWarps * kBoard + lane];
        n_hi = lane < kBoard - 32 ? b[kFwdWarps * kBoard + 32 + lane] : 0;
      }
      float acc[kUnits];
#pragma unroll
      for (int u = 0; u < kUnits; ++u) acc[u] = 0.0f;
      board_features(c_lo, c_hi, flip, hot, [&](int f, float v) {
        const float* col = w1t + f * kPitch + 4 * lane;
#pragma unroll
        for (int g = 0; g < kUnits / 4; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(col + 128 * g);
          acc[4 * g + 0] = fmaf(v, w.x, acc[4 * g + 0]);
          acc[4 * g + 1] = fmaf(v, w.y, acc[4 * g + 1]);
          acc[4 * g + 2] = fmaf(v, w.z, acc[4 * g + 2]);
          acc[4 * g + 3] = fmaf(v, w.w, acc[4 * g + 3]);
        }
      });
      float part = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        part = fmaf(whr[u], fmaxf(acc[u] + b1r[u], 0.0f), part);
      }
      // a butterfly: every lane ends with the same sum
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      const float y = part + bias;
      if (epilogue == kMin) {
        best = fminf(best, y);
      } else if (lane == 0) {
        orow[s] = sign * y;
      }
      c_lo = n_lo;
      c_hi = n_hi;
      b += kFwdWarps * kBoard;
    }
    if (epilogue == kMin) {   // the warps' minima; a min is exact in any order
      if (lane == 0) warp_min[warp] = best;
      __syncthreads();
      if (threadIdx.x == 0) {
        float row_min = kPosInf;
        for (int w = 0; w < kFwdWarps; ++w) {
          row_min = fminf(row_min, warp_min[w]);
        }
        out[r] = row_min;
      }
      __syncthreads();
    }
  }
}

// Dynamic shared memory of a backward block, carved in this order.
struct BwdSmem {
  static constexpr size_t w1s = sizeof(float) * kFeatures * kTilePitch;
  static constexpr size_t dpre = sizeof(float) * kList * kTile;
  static constexpr size_t red = sizeof(float) * 3 * kBwdWarps * kTile;
  static constexpr size_t list = sizeof(int) * kList;
  static constexpr size_t hots = sizeof(int) * kList;
  static constexpr size_t bs = kBoard * kList;
  static constexpr size_t flips = kList;
  static constexpr size_t total =
      w1s + dpre + red + list + hots + bs + flips;
};

// Grid (P, H / 32): block (p, t) sums the gradient of rows p, p + P, ...
// for hidden units 32 t .. 32 t + 31 into its slab of part, P slabs of
// 198 H + 2 H + 1 floats laid out as the flat output: dW1 (H, 198), db1
// (H), dw_head (H), db_head.
__global__ void __launch_bounds__(kBwdThreads, 2)
afterstate_backward_kernel(const int8_t* __restrict__ boards,
                           const int32_t* __restrict__ mover,
                           const int32_t* __restrict__ n_valid,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ wh,
                           const float* __restrict__ grad,
                           float* __restrict__ part, int rows, int m,
                           int hidden, int opponent, int epilogue,
                           float sign) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);        // [198][33]
  float* dpre = w1s + kFeatures * kTilePitch;          // [kList][32]
  float* red = dpre + kList * kTile;                   // [3][warps][32]
  int* list = reinterpret_cast<int*>(red + 3 * kBwdWarps * kTile);
  int* hots = list + kList;                            // [kList]
  int8_t* bs = reinterpret_cast<int8_t*>(hots + kList);  // [kList][52]
  int8_t* flips = bs + kBoard * kList;                 // [kList]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int unit = blockIdx.y * kTile + lane;
  for (int u = warp; u < kTile; u += kBwdWarps) {
    const float* row = w1 + (size_t)(blockIdx.y * kTile + u) * kFeatures;
    for (int f = lane; f < kFeatures; f += 32) {
      w1s[f * kTilePitch + u] = row[f];
    }
  }
  const float b1j = b1[unit], whj = wh[unit];
  __syncthreads();

  // dW1 entries this thread owns: unit `unit`, points a = warp + 16 t (4
  // features each), and one scalar (bar, off or the turn one-hot)
  float pts[kPointsPerWarp][4];
#pragma unroll
  for (int t = 0; t < kPointsPerWarp; ++t) {
    pts[t][0] = pts[t][1] = pts[t][2] = pts[t][3] = 0.0f;
  }
  float scalar = 0.0f;
  float g_b1 = 0.0f, g_wh = 0.0f, g_bh = 0.0f;   // this warp's boards

  // the listed boards' gradients into the sums above, in list order
  auto flush = [&](int count) {
    __syncthreads();
    // 2. each listed board's pre-activations for this tile, one warp a
    //    board: dpre = d w_head (pre > 0), d = sign grad
    for (int i = warp; i < count; i += kBwdWarps) {
      const int e = list[i];
      const int r = e / m;
      const int8_t* b = boards + (size_t)e * kBoard;
      const int c_lo = b[lane];
      const int c_hi = lane < kBoard - 32 ? b[32 + lane] : 0;
      bs[i * kBoard + lane] = (int8_t)c_lo;
      if (lane < kBoard - 32) bs[i * kBoard + 32 + lane] = (int8_t)c_hi;
      const int mv = mover[r];
      const int flip = (mv != 0) ^ opponent;
      const int hot = hot_feature(mv);
      float acc = 0.0f;
      board_features(c_lo, c_hi, flip, hot, [&](int f, float v) {
        acc = fmaf(v, w1s[f * kTilePitch + lane], acc);
      });
      const float pre = acc + b1j;
      const float d = sign * grad[e];
      const float dp = pre > 0.0f ? d * whj : 0.0f;
      dpre[i * kTile + lane] = dp;
      g_wh = fmaf(d, fmaxf(pre, 0.0f), g_wh);
      g_b1 += dp;
      g_bh += d;
      if (lane == 0) {
        flips[i] = (int8_t)flip;
        hots[i] = hot;
      }
    }
    __syncthreads();
    // 3. the dW1 entries this thread owns, over the list in order
    for (int i = 0; i < count; ++i) {
      const float dp = dpre[i * kTile + lane];
      const int flip = flips[i];
      const int8_t* bb = bs + i * kBoard;
#pragma unroll
      for (int t = 0; t < kPointsPerWarp; ++t) {
        const int a = warp + kBwdWarps * t;
        const int c = bb[flip ? 47 - a : a];
        if (c > 0) {
          pts[t][0] += dp;
          if (c >= 2) pts[t][1] += dp;
          if (c >= 3) pts[t][2] += dp;
          if (c > 3) pts[t][3] = fmaf((float)(c - 3) * 0.5f, dp, pts[t][3]);
        }
      }
      if (warp < 4) {         // bar (warps 0, 1), off (2, 3) of q = warp & 1
        const int c = bb[(warp < 2 ? 48 : 50) + ((warp & 1) ^ flip)];
        if (c != 0) {
          const float v = warp < 2 ? (float)c * 0.5f
                                   : __fmul_rn((float)c, kInvCheckers);
          scalar = fmaf(v, dp, scalar);
        }
      } else if (warp < 6) {  // the one-hot of mover warp - 4
        if (hots[i] == 196 + (warp - 4)) scalar += dp;
      }
    }
    __syncthreads();          // before the list is refilled
  };

  // 1. list the kept boards of this block's rows, a row's kept slots in
  //    order, and flush the list whenever it is full
  int count = 0;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int limit = row_limit(n_valid[r], m, epilogue);
    for (int s0 = 0; s0 < limit;) {
      const int take = min(limit - s0, kList - count);
      if (threadIdx.x < take) {
        list[count + threadIdx.x] = r * m + s0 + threadIdx.x;
      }
      count += take;
      s0 += take;
      if (count == kList) {
        flush(count);
        count = 0;
      }
    }
  }
  if (count > 0) flush(count);

  // 4. this block's partial sums into its slab
  const size_t slab_floats = (size_t)kFeatures * hidden + 2 * hidden + 1;
  float* slab = part + (size_t)blockIdx.x * slab_floats;
  float* dw = slab + (size_t)unit * kFeatures;
#pragma unroll
  for (int t = 0; t < kPointsPerWarp; ++t) {
    const int a = warp + kBwdWarps * t;
    const int q = a >= 24;
    const int f = q * kPerPlayer + 4 * (a - 24 * q);
    dw[f] = pts[t][0];
    dw[f + 1] = pts[t][1];
    dw[f + 2] = pts[t][2];
    dw[f + 3] = pts[t][3];
  }
  if (warp < 4) {
    dw[(warp & 1) * kPerPlayer + (warp < 2 ? 96 : 97)] = scalar;
  } else if (warp < 6) {
    dw[196 + (warp - 4)] = scalar;
  }
  red[(0 * kBwdWarps + warp) * kTile + lane] = g_b1;
  red[(1 * kBwdWarps + warp) * kTile + lane] = g_wh;
  red[(2 * kBwdWarps + warp) * kTile + lane] = g_bh;
  __syncthreads();
  if (warp == 0) {
    float s_b1 = 0.0f, s_wh = 0.0f, s_bh = 0.0f;
    for (int w = 0; w < kBwdWarps; ++w) {     // in warp order
      s_b1 += red[(0 * kBwdWarps + w) * kTile + lane];
      s_wh += red[(1 * kBwdWarps + w) * kTile + lane];
      s_bh += red[(2 * kBwdWarps + w) * kTile + lane];
    }
    float* tail = slab + (size_t)kFeatures * hidden;
    tail[unit] = s_b1;
    tail[hidden + unit] = s_wh;
    if (blockIdx.y == 0 && lane == 0) tail[2 * hidden] = s_bh;
  }
}

// out[e] = the sum of the blocks' partials of entry e, in block order.
__global__ void afterstate_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, int blocks,
                                         int entries) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  float s = 0.0f;
  for (int p = 0; p < blocks; ++p) s += part[(size_t)p * entries + e];
  out[e] = s;
}

// What the launches cache (the >48 KB opt-in, the SM count, the resident
// blocks) is the current card's, so it is kept for each card apart.
constexpr int kMaxDevices = 64;

// The current card's index, or -1.
int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return -1;
  }
  return dev;
}

int sm_count(int dev) {
  static int n[kMaxDevices] = {};  // 0: not read yet
  if (n[dev] == 0) {
    int got = 0;
    if (cudaDeviceGetAttribute(&got, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess) {
      return -1;
    }
    n[dev] = got;
  }
  return n[dev];
}

template <int H>
int launch_forward(const int8_t* boards, const int32_t* mover,
                   const int32_t* n, const float* w1, const float* b1,
                   const float* wh, const float* bh, float* out, int rows,
                   int m, int opponent, int epilogue, float sign,
                   cudaStream_t stream) {
  static int per_sm[kMaxDevices] = {};  // resident blocks an SM; 0: unread
  const size_t smem = sizeof(float) * kFeatures * (H + 4);
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {    // before any capture: the >48 KB opt-in
    cudaError_t err = cudaFuncSetAttribute(
        afterstate_eval_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    int got = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &got, afterstate_eval_kernel<H>, kFwdThreads, smem);
    }
    if (err != cudaSuccess) return (int)err;
    if (got < 1 || sm_count(dev) < 1) {
      return (int)cudaErrorInvalidConfiguration;
    }
    per_sm[dev] = got;
  }
  const int blocks = std::min(rows, per_sm[dev] * sm_count(dev));
  if (blocks <= 0) return (int)cudaGetLastError();
  afterstate_eval_kernel<H><<<blocks, kFwdThreads, smem, stream>>>(
      boards, mover, n, w1, b1, wh, bh, out, rows, m, opponent, epilogue,
      sign);
  return (int)cudaGetLastError();
}

// The backward's row blocks, from the shapes alone (so that the sums run
// in the same order on every card).
int backward_blocks(int rows, int m) {
  return rows > 0 && m > 0 ? std::min(rows, kMaxBlocks) : 0;
}

}  // namespace

// The forward pass.  boards (rows, m, 52) int8, mover and n (rows,) int32,
// w1 (hidden, 198), b1 (hidden), wh (1, hidden), bh (1) float32; out
// (rows, m) float32, or (rows) for the min epilogue (2).  hidden is 128 or
// 256; epilogue 0 logits, 1 masked, 2 min.
extern "C" int afterstate_eval_launch(const void* boards, const void* mover,
                                      const void* n, const void* w1,
                                      const void* b1, const void* wh,
                                      const void* bh, void* out, int rows,
                                      int m, int hidden, int opponent,
                                      int epilogue, float sign,
                                      void* stream) {
  if (rows < 0 || m < 0 || epilogue < kLogits || epilogue > kMin) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* bd = (const int8_t*)boards;
  const auto* mv = (const int32_t*)mover;
  const auto* nv = (const int32_t*)n;
  const auto* pw1 = (const float*)w1;
  const auto* pb1 = (const float*)b1;
  const auto* pwh = (const float*)wh;
  const auto* pbh = (const float*)bh;
  auto* po = (float*)out;
  const auto st = (cudaStream_t)stream;
  if (hidden == 128) {
    return launch_forward<128>(bd, mv, nv, pw1, pb1, pwh, pbh, po, rows, m,
                               opponent != 0, epilogue, sign, st);
  }
  if (hidden == 256) {
    return launch_forward<256>(bd, mv, nv, pw1, pb1, pwh, pbh, po, rows, m,
                               opponent != 0, epilogue, sign, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Floats of scratch the backward needs for these shapes.
extern "C" long long afterstate_backward_scratch_floats(int rows, int m,
                                                        int hidden) {
  return (long long)backward_blocks(rows, m) *
         ((long long)kFeatures * hidden + 2 * hidden + 1);
}

// The backward pass: grad (rows, m) float32 is the output's gradient (the
// logits or masked epilogue); dparams (198 hidden + 2 hidden + 1) float32
// gets dW1 (hidden, 198), db1, dw_head, db_head; scratch holds
// afterstate_backward_scratch_floats floats.  bh is not read.
extern "C" int afterstate_backward_launch(const void* boards,
                                          const void* mover, const void* n,
                                          const void* w1, const void* b1,
                                          const void* wh, const void* bh,
                                          const void* grad, void* scratch,
                                          void* dparams, int rows, int m,
                                          int hidden, int opponent,
                                          int epilogue, float sign,
                                          void* stream) {
  static bool opted[kMaxDevices] = {};
  (void)bh;
  if (rows < 0 || m < 0 || (hidden != 128 && hidden != 256) ||
      (epilogue != kLogits && epilogue != kMasked)) {
    return (int)cudaErrorInvalidValue;
  }
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {         // before any capture: the >48 KB opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        afterstate_backward_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BwdSmem::total);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  const int blocks = backward_blocks(rows, m);
  const auto st = (cudaStream_t)stream;
  if (blocks > 0) {
    afterstate_backward_kernel<<<dim3(blocks, hidden / kTile), kBwdThreads,
                                 BwdSmem::total, st>>>(
        (const int8_t*)boards, (const int32_t*)mover, (const int32_t*)n,
        (const float*)w1, (const float*)b1, (const float*)wh,
        (const float*)grad, (float*)scratch, rows, m, hidden, opponent != 0,
        epilogue, sign);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int entries = kFeatures * hidden + 2 * hidden + 1;
  afterstate_reduce_kernel<<<(entries + 255) / 256, 256, 0, st>>>(
      (const float*)scratch, (float*)dparams, blocks, entries);
  return (int)cudaGetLastError();
}
