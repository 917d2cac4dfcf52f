// The dense layers of a deep afterstate network for Hopper (sm_90a), forward
// and backward, on the kept boards only.  The first layer (fc1) runs in
// csrc/afterstate.cu, which writes the post-ReLU activations of every kept
// board, in its global order of kept boards, into h1 (cap, ld[0]), each
// board's element r m + s into elem and their number into count; this source
// takes them from there:
//
//   h_l = relu(W_l h_{l-1} + b_l)      l = 1 .. L  (W_l (width[l], width[l-1]))
//   z   = W_head h_L + b_head          (heads outputs)
//   y   = z_0                          (a scalar head: score, or value)
//       = softmax(z) . reward          (the outcome head)
//   out[elem[g]] = sign y
//
// What bounds it.  The kept count lives on the card (about 31 of a board
// position's 256 slots at a rollout step, 8 times fewer than the slots), so
// no library product fits without a host sync: the grids are sized for the
// capacity (rows x slots) and every block reads the count and walks tiles of
// 64 kept rows up to it; blocks past it do no work, and a graph captures the
// launches.  The products are float32 FMA on the CUDA cores: both operands of
// a dense layer are float32 numbers that bf16 does not hold (unlike fc1's
// features), so an exact tensor-core form needs six or nine split products,
// which is left for later.  Per kept row the wildbg trunk (300, 250, 200) is
// 125,200 multiply-adds forward and three times that with the backward.
//
// - dense_forward_kernel: a persistent grid; a block takes tiles of 64 kept
//   rows, loads h1's tile k-major into shared memory ([k][row], 68 floats a
//   row so that four-row stores and row-wise reads meet no bank conflict),
//   runs each layer as a 64 x 256-column product round (a thread 8 rows x 8
//   columns: its rows' activations read as two broadcast float4, the layer's
//   weights staged 16 k at a time in two buffers), adds the bias and ReLU in
//   registers into the other buffer (and, for the backward, h_l into act[l]),
//   then the head (four lanes a row, a fixed order of sums) and the epilogue.
// - dense_backward_kernel: a fixed number of blocks (a number of the shapes,
//   never of the card), each a contiguous range of tiles: the head again from
//   the saved h_L, dz, the head's weight and bias gradients into the block's
//   partials in shared memory, then dpre_L = W_head^T dz [h_L > 0] and, layer
//   by layer, dpre_{l-1} = W_l^T dpre_l [h_{l-1} > 0], each written to
//   dpre[l] (dpre[0], fc1's, is what csrc/afterstate.cu's deep backward takes).
// - dense_wgrad_kernel: dW_l and db_l as one product over the kept rows,
//   dpre_l^T [h_{l-1}, 1], tiles of 64 inputs x 256 outputs, split into a
//   fixed number of row slices, each slice's partial into scratch.
// - dense_reduce_kernel: every gradient entry, the partials summed in slice
//   (block) order.  No float sum uses an atomic, so the gradients are the same
//   bits on every run and card.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;           // kept rows a tile
constexpr int kLd = kRows + 4;      // floats between two units' rows in smem
constexpr int kMaxWidth = 320;      // widest layer
constexpr int kMaxLayers = 8;       // dense layers after fc1
constexpr int kMaxHeads = 8;        // head outputs
constexpr int kCols = 256;          // output columns a product round
constexpr int kKC = 16;             // k a staged chunk
constexpr int kWS = kCols + 1;      // floats between two k of a staged chunk
constexpr int kXT = 64;             // wgrad: inputs a tile
constexpr unsigned kFull = 0xffffffffu;

struct Net {
  int layers;                       // L >= 1
  int heads;                        // J
  int outcome;                      // 1: softmax(z) . reward
  int capacity;                     // rows of every buffer
  int slices;                       // wgrad row slices
  float sign;
  int width[kMaxLayers + 1];        // width[0]: fc1's
  int ld[kMaxLayers + 1];           // row stride of a buffer of width[l]
  float reward[kMaxHeads];
  const float* w[kMaxLayers];       // W_{l+1}
  const float* b[kMaxLayers];
  const float* wh;
  const float* bh;
  const float* h1;                  // (capacity, ld[0])
  float* act[kMaxLayers];           // h_{l+1} (capacity, ld[l+1]), or null
  float* dpre[kMaxLayers + 1];      // dpre_l (capacity, ld[l])
  const int* elem;
  const int* count;
  const float* grad;                // (rows m) backward
  float* out;                       // (rows m) forward
  float* part_rows;                 // (row blocks, heads (width[L] + 1))
  float* part_w;                    // (slices, sum width[l] (width[l-1] + 1))
  float* dflat;                     // the gradients, parameter order
};

constexpr size_t kActFloats = (size_t)kMaxWidth * kLd;        // 21,760
constexpr size_t kWFloats = 2ull * kKC * kWS;                 // 8,224
constexpr size_t kHeadFloats = (size_t)kMaxHeads * (kMaxWidth + 1);
constexpr size_t kSmemForward = 4 * (2 * kActFloats + kWFloats);
constexpr size_t kSmemBackward =
    4 * (2 * kActFloats + kWFloats + kHeadFloats + kMaxHeads * kRows);
constexpr size_t kSmemWgrad = 4ull * 2 * kKC * (kXT + kCols);

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// The staged chunk of k0 .. k0 + 15: thread tid's 16 elements B(k0 + kk,
// n0 + c), 0 past K or past N.  Where k is contiguous in memory (sk == 1, a
// weight's rows) a warp reads two rows' 16 k, else 32 consecutive c of one k:
// every load coalesced either way.
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ src,
                                            long long sk, long long sc,
                                            int k0, int K, int n0, int N,
                                            float (&v)[kKC]) {
  const bool krow = sk == 1;
#pragma unroll
  for (int q = 0; q < kKC; ++q) {
    const int e = threadIdx.x + kThreads * q;
    const int c = krow ? e / kKC : e % kCols;
    const int kk = krow ? e % kKC : e / kCols;
    const int k = k0 + kk, n = n0 + c;
    v[q] = k < K && n < N ? __ldg(src + k * sk + n * sc) : 0.0f;
  }
}

__device__ __forceinline__ void store_chunk(float* wb, long long sk,
                                            const float (&v)[kKC]) {
  const bool krow = sk == 1;
#pragma unroll
  for (int q = 0; q < kKC; ++q) {
    const int e = threadIdx.x + kThreads * q;
    const int c = krow ? e / kKC : e % kCols;
    const int kk = krow ? e % kKC : e / kCols;
    wb[kk * kWS + c] = v[q];
  }
}

// acc[i][j] = sum_k in[k][8 ty + i] B(k, n0 + tx + 32 j) for k < K, where
// B(k, c) = src[k sk + c sc] (0 past K or past N).  in is k-major in shared
// memory with rows [K, round16(K)) zero; wbuf holds two staged chunks, one
// loaded from memory while the other is read.  Ends with a block barrier,
// after which wbuf is free.
__device__ __forceinline__ void product_round(const float* in, int K,
                                              const float* __restrict__ src,
                                              long long sk, long long sc,
                                              int n0, int N, float* wbuf,
                                              float (&acc)[8][8]) {
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int chunks = (K + kKC - 1) / kKC;
  float v[kKC];
  fetch_chunk(src, sk, sc, 0, K, n0, N, v);
  store_chunk(wbuf, sk, v);
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    const int k0 = ch * kKC;
    if (ch + 1 < chunks) fetch_chunk(src, sk, sc, k0 + kKC, K, n0, N, v);
    const float* wb = wbuf + buf * kKC * kWS;
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float* arow = in + (k0 + kk) * kLd + 8 * ty;
      const float4 a0 = *reinterpret_cast<const float4*>(arow);
      const float4 a1 = *reinterpret_cast<const float4*>(arow + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = wb[kk * kWS + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    if (ch + 1 < chunks) store_chunk(wbuf + (buf ^ 1) * kKC * kWS, sk, v);
    __syncthreads();
  }
}

// Four consecutive rows' values of unit n into the k-major buffer.
__device__ __forceinline__ void store4(float* dst, int n, int row0, float a,
                                       float b, float c, float d) {
  *reinterpret_cast<float4*>(dst + n * kLd + row0) = make_float4(a, b, c, d);
}

// A tile of rows [g0, g0 + nrows) of src (capacity, ld), width K, into the
// k-major buffer dst: rows [K, round16(K)) and rows past nrows zero.  A warp
// takes 32 consecutive rows of one float4 column.
__device__ void load_tile(const float* __restrict__ src, int ld, int K,
                          int g0, int nrows, float* dst) {
  const int q4 = round16(K) / 4;
  for (int idx = threadIdx.x; idx < kRows * q4; idx += kThreads) {
    const int row = idx % kRows, k = 4 * (idx / kRows);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < nrows && k < K) {
      v = *reinterpret_cast<const float4*>(src + (size_t)(g0 + row) * ld + k);
      if (k + 1 >= K) v.y = 0.0f;
      if (k + 2 >= K) v.z = 0.0f;
      if (k + 3 >= K) v.w = 0.0f;
    }
    dst[k * kLd + row] = v.x;
    dst[(k + 1) * kLd + row] = v.y;
    dst[(k + 2) * kLd + row] = v.z;
    dst[(k + 3) * kLd + row] = v.w;
  }
}

// The head's z of row tid / 4 (each of the row's four lanes ends with all of
// them): lane tid % 4 sums k = lane, lane + 4, ..., then the four lanes'
// sums meet by two shuffles.  hl is h_L, k-major.
__device__ __forceinline__ void head_z(const Net& a, const float* hl,
                                       float (&z)[kMaxHeads]) {
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int K = a.width[a.layers];
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) {
    float s = 0.0f;
    if (j < a.heads) {
      const float* wj = a.wh + (size_t)j * K;
      for (int k = part; k < K; k += 4) {
        s = fmaf(__ldg(wj + k), hl[k * kLd + row], s);
      }
    }
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    z[j] = j < a.heads ? s + __ldg(a.bh + j) : 0.0f;
  }
}

// y of z, and (outcome) the probabilities into p.
__device__ __forceinline__ float head_y(const Net& a, const float (&z)[kMaxHeads],
                                       float (&p)[kMaxHeads]) {
  if (!a.outcome) {
    p[0] = 1.0f;
    return z[0];
  }
  float mx = z[0];
#pragma unroll
  for (int j = 1; j < kMaxHeads; ++j) {
    if (j < a.heads) mx = fmaxf(mx, z[j]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) {
    p[j] = j < a.heads ? expf(z[j] - mx) : 0.0f;
    sum += p[j];
  }
  float y = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) {
    p[j] = p[j] / sum;
    y = fmaf(p[j], a.reward[j], y);
  }
  return y;
}

// The forward.  Tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the kept
// rows; act[l] written where given.
__global__ void __launch_bounds__(kThreads, 1) dense_forward_kernel(Net a) {
  extern __shared__ __align__(16) float smem[];
  float* bufA = smem;
  float* bufB = smem + kActFloats;
  float* wbuf = smem + 2 * kActFloats;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int count = *a.count;
  const int tiles = (count + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * kRows, nrows = min(kRows, count - g0);
    load_tile(a.h1, a.ld[0], a.width[0], g0, nrows, bufA);
    __syncthreads();
    float* cur = bufA;
    float* nxt = bufB;
    for (int l = 0; l < a.layers; ++l) {
      const int K = a.width[l], N = a.width[l + 1], Np = round16(N);
      const float* w = a.w[l];
      const float* bias = a.b[l];
      float* save = a.act[l];
      for (int n0 = 0; n0 < Np; n0 += kCols) {
        float acc[8][8];
        product_round(cur, K, w, 1, K, n0, N, wbuf, acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + tx + 32 * j;
          if (n < Np) {
            const float bn = n < N ? __ldg(bias + n) : 0.0f;
            float h[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              h[i] = n < N ? fmaxf(acc[i][j] + bn, 0.0f) : 0.0f;
            }
            store4(nxt, n, 8 * ty, h[0], h[1], h[2], h[3]);
            store4(nxt, n, 8 * ty + 4, h[4], h[5], h[6], h[7]);
            if (save != nullptr && n < N) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int row = 8 * ty + i;
                if (row < nrows) save[(size_t)(g0 + row) * a.ld[l + 1] + n] = h[i];
              }
            }
          }
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    float z[kMaxHeads], p[kMaxHeads];
    head_z(a, cur, z);
    const float y = head_y(a, z, p);
    const int row = tid >> 2;
    if ((tid & 3) == 0 && row < nrows) a.out[a.elem[g0 + row]] = a.sign * y;
    __syncthreads();   // cur is the next tile's bufA or bufB
  }
}

// The backward's rows: dz, the head's gradients into the block's partials and
// every layer's dpre.  Block b takes tiles [T b / G, T (b + 1) / G).
__global__ void __launch_bounds__(kThreads, 1) dense_backward_kernel(Net a) {
  extern __shared__ __align__(16) float smem[];
  float* bufA = smem;
  float* bufB = smem + kActFloats;
  float* wbuf = smem + 2 * kActFloats;
  float* hsum = wbuf + kWFloats;
  float* dzs = hsum + kHeadFloats;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int L = a.layers, J = a.heads, KL = a.width[L];
  const int nhead = J * (KL + 1);
  for (int o = tid; o < nhead; o += kThreads) hsum[o] = 0.0f;
  const int count = *a.count;
  const long long tiles = (count + kRows - 1) / kRows;
  const int t0 = (int)(tiles * blockIdx.x / gridDim.x);
  const int t1 = (int)(tiles * (blockIdx.x + 1) / gridDim.x);
  for (int tile = t0; tile < t1; ++tile) {
    const int g0 = tile * kRows, nrows = min(kRows, count - g0);
    load_tile(a.act[L - 1], a.ld[L], KL, g0, nrows, bufA);
    __syncthreads();
    {
      float z[kMaxHeads], p[kMaxHeads];
      head_z(a, bufA, z);
      const float y = head_y(a, z, p);
      const int row = tid >> 2;
      const float dy =
          row < nrows ? a.sign * __ldg(a.grad + a.elem[g0 + row]) : 0.0f;
      if ((tid & 3) == 0) {
#pragma unroll
        for (int j = 0; j < kMaxHeads; ++j) {
          if (j < J) {
            dzs[j * kRows + row] =
                a.outcome ? dy * p[j] * (a.reward[j] - y) : dy;
          }
        }
      }
    }
    __syncthreads();
    // the head's weights (j, k < K) and bias (j, K): this tile's rows in
    // order, into this thread's entries
    for (int o = tid; o < nhead; o += kThreads) {
      const int j = o / (KL + 1), k = o - j * (KL + 1);
      const float* dz = dzs + j * kRows;
      float s = 0.0f;
      if (k < KL) {
        const float* h = bufA + k * kLd;
        for (int r = 0; r < kRows; ++r) s = fmaf(dz[r], h[r], s);
      } else {
        for (int r = 0; r < kRows; ++r) s += dz[r];
      }
      hsum[o] += s;
    }
    // dpre_L = W_head^T dz where h_L > 0, into bufB and dpre[L]
    {
      const int Kp = round16(KL);
      float* dst = a.dpre[L];
      for (int idx = tid; idx < kRows * Kp; idx += kThreads) {
        const int row = idx / Kp, k = idx - row * Kp;
        float d = 0.0f;
        if (k < KL) {
#pragma unroll
          for (int j = 0; j < kMaxHeads; ++j) {
            if (j < J) d = fmaf(__ldg(a.wh + (size_t)j * KL + k),
                                dzs[j * kRows + row], d);
          }
          if (!(bufA[k * kLd + row] > 0.0f)) d = 0.0f;
          if (row < nrows) dst[(size_t)(g0 + row) * a.ld[L] + k] = d;
        }
        bufB[k * kLd + row] = d;
      }
    }
    __syncthreads();
    float* cur = bufB;    // dpre_l
    float* nxt = bufA;
    for (int l = L; l >= 1; --l) {
      const int K = a.width[l], N = a.width[l - 1], Np = round16(N);
      const float* w = a.w[l - 1];   // W_l (width[l], width[l-1])
      const float* h = l >= 2 ? a.act[l - 2] : a.h1;
      const int ldh = a.ld[l - 1];
      float* dst = a.dpre[l - 1];
      for (int n0 = 0; n0 < Np; n0 += kCols) {
        float acc[8][8];
        product_round(cur, K, w, N, 1, n0, N, wbuf, acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + tx + 32 * j;
          if (n < Np) {
            float d[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int row = 8 * ty + i;
              d[i] = 0.0f;
              if (n < N && row < nrows) {
                const size_t at = (size_t)(g0 + row) * ldh + n;
                d[i] = h[at] > 0.0f ? acc[i][j] : 0.0f;
                dst[(size_t)(g0 + row) * a.ld[l - 1] + n] = d[i];
              }
            }
            if (l >= 2) {
              store4(nxt, n, 8 * ty, d[0], d[1], d[2], d[3]);
              store4(nxt, n, 8 * ty + 4, d[4], d[5], d[6], d[7]);
            }
          }
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  float* slab = a.part_rows + (size_t)blockIdx.x * nhead;
  for (int o = tid; o < nhead; o += kThreads) slab[o] = hsum[o];
}

// The layer and tile of wgrad block x: layers in order, each
// ceil((width[l-1] + 1) / 64) x ceil(width[l] / 256) tiles; false past them.
__device__ __forceinline__ bool wgrad_tile(const Net& a, int x, int& l,
                                           int& x0, int& y0, int& off) {
  off = 0;
  for (l = 1; l <= a.layers; ++l) {
    const int K = a.width[l - 1] + 1, N = a.width[l];
    const int xt = (K + kXT - 1) / kXT, yt = (N + kCols - 1) / kCols;
    if (x < xt * yt) {
      x0 = kXT * (x % xt);
      y0 = kCols * (x / xt);
      return true;
    }
    x -= xt * yt;
    off += K * N;
  }
  return false;
}

// dW_l and db_l, (width[l], width[l-1] + 1) with the bias last: block (x, s)
// sums tile x over row slice s, rows [count s / S, count (s + 1) / S).
__global__ void __launch_bounds__(kThreads, 2) dense_wgrad_kernel(Net a) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                      // [2][16][64]
  float* ys = smem + 2 * kKC * kXT;      // [2][16][256]
  int l, x0, y0, off;
  if (!wgrad_tile(a, blockIdx.x, l, x0, y0, off)) return;
  const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
  const int K = a.width[l - 1], N = a.width[l];
  const float* h = l >= 2 ? a.act[l - 2] : a.h1;
  const int ldh = a.ld[l - 1];
  const float* d = a.dpre[l];
  const int ldd = a.ld[l];
  const long long count = *a.count;
  const int r0 = (int)(count * blockIdx.y / a.slices);
  const int r1 = (int)(count * (blockIdx.y + 1) / a.slices);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  // a chunk of 16 rows: x values 4 a thread, y values 16 a thread
  float xv[4], yv[16];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + kThreads * q, r = idx / kXT, x = x0 + idx % kXT;
      const int row = c0 + r;
      float v = 0.0f;
      if (row < r1) v = x < K ? __ldg(h + (size_t)row * ldh + x)
                              : (x == K ? 1.0f : 0.0f);
      xv[q] = v;
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int r = q, y = y0 + tid, row = c0 + r;
      yv[q] = row < r1 && y < N ? __ldg(d + (size_t)row * ldd + y) : 0.0f;
    }
  };
  auto store = [&](int buf) {
    float* xb = xs + buf * kKC * kXT;
    float* yb = ys + buf * kKC * kCols;
#pragma unroll
    for (int q = 0; q < 4; ++q) xb[tid + kThreads * q] = xv[q];
#pragma unroll
    for (int q = 0; q < 16; ++q) yb[q * kCols + tid] = yv[q];
  };
  const int chunks = (r1 - r0 + kKC - 1) / kKC;
  if (chunks > 0) {
    fetch(r0);
    store(0);
  }
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < chunks) fetch(r0 + (ch + 1) * kKC);
    const float* xb = xs + buf * kKC * kXT;
    const float* yb = ys + buf * kKC * kCols;
#pragma unroll
    for (int r = 0; r < kKC; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(xb + r * kXT + 8 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xb + r * kXT + 8 * ty + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = yb[r * kCols + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (ch + 1 < chunks) store(buf ^ 1);
    __syncthreads();
  }
  // slice s's slab: the whole augmented layout, sum width[l] (width[l-1]+1)
  size_t total = 0;
  for (int q = 1; q <= a.layers; ++q) {
    total += (size_t)a.width[q] * (a.width[q - 1] + 1);
  }
  float* part = a.part_w + (size_t)blockIdx.y * total + off;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int y = y0 + tx + 32 * j;
    if (y >= N) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int x = x0 + 8 * ty + i;
      if (x <= K) part[(size_t)y * (K + 1) + x] = acc[i][j];
    }
  }
}

// dflat[e], parameter order (W_1, b_1, ..., W_L, b_L, W_head, b_head): the
// partials of its entry summed in slice or block order.
__global__ void dense_reduce_kernel(Net a, int row_blocks, int entries) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  size_t total = 0;
  for (int q = 1; q <= a.layers; ++q) {
    total += (size_t)a.width[q] * (a.width[q - 1] + 1);
  }
  int rest = e;
  size_t off = 0;
  for (int l = 1; l <= a.layers; ++l) {
    const int K = a.width[l - 1], N = a.width[l];
    if (rest < N * (K + 1)) {
      const size_t at = rest < N * K
                            ? off + (size_t)(rest / K) * (K + 1) + rest % K
                            : off + (size_t)(rest - N * K) * (K + 1) + K;
      float s = 0.0f;
      for (int q = 0; q < a.slices; ++q) s += a.part_w[q * total + at];
      a.dflat[e] = s;
      return;
    }
    rest -= N * (K + 1);
    off += (size_t)N * (K + 1);
  }
  const int KL = a.width[a.layers], J = a.heads;
  const int nhead = J * (KL + 1);
  const int at = rest < J * KL ? (rest / KL) * (KL + 1) + rest % KL
                               : (rest - J * KL) * (KL + 1) + KL;
  float s = 0.0f;
  for (int q = 0; q < row_blocks; ++q) s += a.part_rows[(size_t)q * nhead + at];
  a.dflat[e] = s;
}

constexpr int kMaxDevices = 64;

int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return -1;
  }
  return dev;
}

// The >48 KB opt-ins and the forward's resident blocks, once a card (before
// any capture).
int prepare(int dev, int* resident) {
  static int blocks[kMaxDevices] = {};
  if (blocks[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemForward);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(dense_backward_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemBackward);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(dense_wgrad_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemWgrad);
    }
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dense_forward_kernel, kThreads, kSmemForward);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
    blocks[dev] = per_sm * sms;
  }
  *resident = blocks[dev];
  return 0;
}

// The network of the C arguments, checked; 0 or a CUDA error code.
int make_net(Net& a, int layers, const int* widths, const int* lds,
             const void* const* w, const void* const* b, const void* wh,
             const void* bh, int heads, int outcome, const float* reward,
             const void* h1, void* const* act, void* const* dpre,
             const void* elem, const void* count, int capacity, float sign) {
  if (layers < 1 || layers > kMaxLayers || heads < 1 || heads > kMaxHeads ||
      capacity < 0 || (outcome && heads < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  a = Net{};
  a.layers = layers;
  a.heads = heads;
  a.outcome = outcome != 0;
  a.capacity = capacity;
  a.sign = sign;
  for (int l = 0; l <= layers; ++l) {
    if (widths[l] < 1 || widths[l] > kMaxWidth || lds[l] < widths[l] ||
        lds[l] % 4 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    a.width[l] = widths[l];
    a.ld[l] = lds[l];
  }
  for (int j = 0; j < heads; ++j) a.reward[j] = reward ? reward[j] : 0.0f;
  for (int l = 0; l < layers; ++l) {
    a.w[l] = (const float*)w[l];
    a.b[l] = (const float*)b[l];
    a.act[l] = act ? (float*)act[l] : nullptr;
  }
  for (int l = 0; l <= layers && dpre; ++l) a.dpre[l] = (float*)dpre[l];
  a.wh = (const float*)wh;
  a.bh = (const float*)bh;
  a.h1 = (const float*)h1;
  a.elem = (const int*)elem;
  a.count = (const int*)count;
  return 0;
}

}  // namespace

// The forward: out (rows m) float32 gets sign y at each kept board's element
// (its floors are csrc/afterstate.cu's); act, where not null, L pointers to
// (capacity, lds[l + 1]) buffers for the backward.  widths and lds: L + 1
// ints (fc1's first), lds multiples of 4; w, b: L pointers; reward: heads
// floats on the host (outcome), or null.
extern "C" int dense_forward_launch(int layers, const int* widths,
                                    const int* lds, const void* const* w,
                                    const void* const* b, const void* wh,
                                    const void* bh, int heads, int outcome,
                                    const float* reward, const void* h1,
                                    void* const* act, const void* elem,
                                    const void* count, void* out,
                                    int capacity, float sign, void* stream) {
  Net a;
  int err = make_net(a, layers, widths, lds, w, b, wh, bh, heads, outcome,
                     reward, h1, act, nullptr, elem, count, capacity, sign);
  if (err != 0) return err;
  a.out = (float*)out;
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  int resident = 0;
  err = prepare(dev, &resident);
  if (err != 0) return err;
  const int tiles = (capacity + kRows - 1) / kRows;
  const int grid = std::min(tiles, resident);
  if (grid > 0) {
    dense_forward_kernel<<<grid, kThreads, kSmemForward,
                           (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The backward: grad (rows m) float32, the output's gradient; act the
// forward's saved activations; dpre L + 1 pointers to (capacity, lds[l])
// buffers that get every layer's dpre (dpre[0]: fc1's); part_rows holds
// row_blocks heads (widths[L] + 1) floats, part_w slices x sum widths[l]
// (widths[l-1] + 1); dflat gets the gradients in parameter order (W_1, b_1,
// ..., W_L, b_L, W_head, b_head).  row_blocks and slices are numbers of the
// shapes (ops/dense.py).
extern "C" int dense_backward_launch(
    int layers, const int* widths, const int* lds, const void* const* w,
    const void* const* b, const void* wh, const void* bh, int heads,
    int outcome, const float* reward, const void* h1, void* const* act,
    void* const* dpre, const void* elem, const void* count, const void* grad,
    void* part_rows, int row_blocks, void* part_w, int slices, void* dflat,
    int capacity, float sign, void* stream) {
  Net a;
  int err = make_net(a, layers, widths, lds, w, b, wh, bh, heads, outcome,
                     reward, h1, act, dpre, elem, count, capacity, sign);
  if (err != 0) return err;
  if (row_blocks < 0 || slices < 1 || act == nullptr || dpre == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  a.grad = (const float*)grad;
  a.part_rows = (float*)part_rows;
  a.part_w = (float*)part_w;
  a.slices = slices;
  a.dflat = (float*)dflat;
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  int resident = 0;
  err = prepare(dev, &resident);
  if (err != 0) return err;
  const auto st = (cudaStream_t)stream;
  if (row_blocks > 0) {
    dense_backward_kernel<<<row_blocks, kThreads, kSmemBackward, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int tiles = 0, entries = 0;
  for (int l = 1; l <= layers; ++l) {
    const int K = widths[l - 1] + 1, N = widths[l];
    tiles += ((K + kXT - 1) / kXT) * ((N + kCols - 1) / kCols);
    entries += K * N;
  }
  entries += heads * (widths[layers] + 1);
  dense_wgrad_kernel<<<dim3(tiles, slices), kThreads, kSmemWgrad, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dense_reduce_kernel<<<(entries + 255) / 256, 256, 0, st>>>(a, row_blocks,
                                                            entries);
  return (int)cudaGetLastError();
}
