// Batched stable compaction for Hopper (sm_90a): the movegen hot op.
//
// compact_rows_launch replaces both Pallas TPU kernels of
// mlp_ppo_2ply_p3_tpu/ops/compaction.py: compact_rows (the one-hot int8
// matmul, pallas_call at :231) and compact_rows_segmented (the 128-wide
// segmented one-hot, pallas_call at :178).  Both compute one function:
//
//   payload (B, N, C) int8, valid (B, N) uint8/bool, k_out
//   -> out (B, k_out, C) int8: the valid rows of each batch row, in their
//      original order, then zeros;
//      count (B,) int32: the number of valid rows (may exceed k_out).
//
// It is bound by bytes on the card: it reads the flags and the payload
// rows that land in the output and writes the output.  What the design
// does about the bytes:
//
// - Flags are read 16 bytes per thread (one aligned uint4 per load, bytes
//   outside the row masked) and ranked with popc over the 16-bit mask, so
//   one round of scan barriers covers 4096 flags of a 256-thread block.
// - The layout follows (B, N):
//   * B < 264 (twice the SMs) and N >= 1024 (the sub-batch splits, B = 1):
//     N is cut into tiles of 16-byte flag chunks over a (tiles, B) grid, in
//     two launches: tile counts, then per tile an exclusive prefix over the
//     earlier tiles' counts, the ranking and the copy;
//   * N <= 256 (the k1 call and the first doubles level, N = 27): one warp
//     per batch row, 4 rows per block, warp shuffles and no block barriers;
//   * otherwise one block per batch row: 4 warps up to N = 4096, 8 above.
//     At 64-80 registers a thread, 128-thread blocks fit twice as many rows
//     on an SM at once, which the latency-bound levels (B = 875) need; the
//     widest rows need the flags of 8 warps per round.
// - Rows are copied by half-warps, one 4-byte word a lane; where C % 4 != 0
//   a lane loads the aligned word around its bytes and stores those bytes.
//   Each lane has the words of four rows in flight at once.  A block
//   copies into a shared-memory image of the contiguous output run, placed
//   at the run's own offset modulo 16, so the run is written with 16-byte
//   stores and only its unaligned head and tail go byte by byte.  The zero
//   tail is written the same way.  A warp's runs are too short for the
//   image to pay: it stores its rows straight to the output.
// - Once a row's running count reaches k_out, later chunks are only
//   counted: their payload is never read.
//
// The TPU's one-hot matmuls, 128-wide segments and 8-aligned merges were
// shapes for the MXU and Mosaic and are not carried over.  Nothing here
// allocates: the caller passes the outputs and the tile-count scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // split-layout blocks
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRowsPerBlock = 4;   // warp layout: rows of a block
constexpr int kWarpRowMaxN = 256;      // up to this N: one warp per row
constexpr int kWideRowMinN = 4097;     // from this N: 8 warps per row, else 4
constexpr int kSplitMaxRows = 2 * 132; // fewer rows than this: split N
constexpr int kSplitMinN = 1024;
constexpr int kBlockBufBytes = 16384;  // most output image of a block group
constexpr int kMaxSmem = 232448;       // 227 KB, the most a block can use

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

template <int kGroupWarps>
__device__ __forceinline__ void group_sync() {
  if (kGroupWarps == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Exclusive prefix of v over the group's threads (thread order); `total`
// gets the group's sum.  A block group writes warp_tot: the caller syncs
// before the next call.
template <int kGroupWarps>
__device__ __forceinline__ int group_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (kGroupWarps == 1) {
    total = __shfl_sync(0xffffffffu, x, 31);
    return x - v;
  }
  const int warp = (threadIdx.x >> 5) & (kGroupWarps - 1);
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kGroupWarps; ++w) {
    const int t = warp_tot[w];
    before += (w < warp) ? t : 0;
    total += t;
  }
  return before + x - v;
}

// Sum of v over the block; red holds kWarps ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// One batch row's flags are bytes [v0, v0 + n) of the flag array.  Its
// chunks are the 16-byte aligned blocks that overlap them: chunk c starts
// at abase + 16 c, and its byte j is flag 16 c + j - lead.  An aligned
// block that holds one byte of the tensor lies inside its allocation.
struct FlagRow {
  const uint8_t* abase;
  int lead;
  int n;
  int nchunks;
};

__device__ __forceinline__ FlagRow flag_row(const uint8_t* valid, int b,
                                            int n) {
  FlagRow r;
  const uint8_t* v0 = valid + (size_t)b * n;
  r.abase = reinterpret_cast<const uint8_t*>((uintptr_t)v0 & ~(uintptr_t)15);
  r.lead = (int)(v0 - r.abase);
  r.n = n;
  r.nchunks = n > 0 ? (r.lead + n + 15) >> 4 : 0;
  return r;
}

// Bit j of the result: byte j of chunk c is a flag of the row and nonzero.
__device__ __forceinline__ unsigned chunk_bits(const FlagRow& r, int c) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(r.abase) + c);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned m = __vcmpne4(w[k], 0u);  // 0xff in each nonzero byte
    bits |= (((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
             ((m >> 28) & 8u)) << (4 * k);
  }
  const int first = 16 * c - r.lead;  // flag index of byte 0
  if (first < 0) bits &= 0xffffu << (-first);
  const int in_row = r.n - first;     // >= 1 for c < nchunks
  if (in_row < 16) bits &= (1u << in_row) - 1u;
  return bits;
}

// Copy rows r = hw, hw + kHalfWarps, ... < rows of c bytes, row r from
// src_rows + (src_base + src_idx[r]) * c, to img + r * c: one half-warp per
// row, lane hl on the row's 4-byte word hl (and hl + 16, ...).  With
// kWords the rows and the image are 4-byte aligned; otherwise each lane
// loads the aligned word around its bytes (inside the tensor's allocation,
// as the row overlaps it) and stores the row's bytes of it.  Each lane
// loads its word of kUnroll rows before it stores any, so that those loads
// are in flight together.
template <int kHalfWarps, bool kWords>
__device__ __forceinline__ void copy_rows(int8_t* img,
                                          const int8_t* src_rows,
                                          const uint16_t* src_idx,
                                          int src_base, int rows, int c,
                                          int hw, int hl) {
  constexpr int kUnroll = 4;
  const int nwords = kWords ? (c >> 2) : ((c + 6) >> 2);
  for (int w = hl; w - hl < nwords; w += 16) {
    for (int r0 = hw; r0 < rows; r0 += kUnroll * kHalfWarps) {
      uint32_t x[kUnroll];
      int skew[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kHalfWarps;
        x[u] = 0u;
        skew[u] = 0;
        if (r < rows) {
          const int8_t* s = src_rows + (size_t)(src_base + src_idx[r]) * c;
          const uintptr_t base = (uintptr_t)s & ~(uintptr_t)3;
          skew[u] = (int)((uintptr_t)s - base);
          if (4 * w < skew[u] + c) {
            x[u] = __ldg(reinterpret_cast<const uint32_t*>(base) + w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kHalfWarps;
        if (r >= rows) continue;
        int8_t* d = img + r * c;
        if (kWords) {
          if (w < nwords) reinterpret_cast<uint32_t*>(d)[w] = x[u];
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = 4 * w + q - skew[u];
            if (e >= 0 && e < c) d[e] = (int8_t)(x[u] >> (8 * q));
          }
        }
      }
    }
  }
}

// Write len bytes to dst from src (zeros if src is null), where src and
// dst agree modulo 16: 16-byte stores for the aligned middle, bytes for
// the head and tail.  Threads t of nt share the work.
__device__ __forceinline__ void store_run(int8_t* dst, const int8_t* src,
                                          int len, int t, int nt) {
  if (len <= 0) return;
  const uintptr_t d0 = (uintptr_t)dst, d1 = d0 + (uintptr_t)len;
  uintptr_t a0 = (d0 + 15) & ~(uintptr_t)15;
  uintptr_t a1 = d1 & ~(uintptr_t)15;
  if (a0 > d1) a0 = d1;
  if (a1 < a0) a1 = a0;
  const int head = (int)(a0 - d0);
  const int mid = (int)((a1 - a0) >> 4);
  const int tail_at = head + 16 * mid;
  const int tail = len - tail_at;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  if (src == nullptr) {
    for (int e = t; e < head; e += nt) dst[e] = 0;
    for (int e = t; e < mid; e += nt) d4[e] = make_uint4(0u, 0u, 0u, 0u);
    for (int e = t; e < tail; e += nt) dst[tail_at + e] = 0;
  } else {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    for (int e = t; e < head; e += nt) dst[e] = src[e];
    for (int e = t; e < mid; e += nt) d4[e] = s4[e];
    for (int e = t; e < tail; e += nt) dst[tail_at + e] = src[tail_at + e];
  }
}

// Shared memory of one group: warp totals, the round's landing rows
// (round-local flag offsets; a round lands at most min(16 x threads,
// k_out) rows), and for a block group the output image (at most
// min(N, k_out) rows, up to buf_cap bytes, and 16 bytes for its offset;
// buf_cap 0: none).  Sized per call, so that small shapes keep the shared
// memory of a block small.
struct GroupSizes {
  int src_bytes;
  int buf_bytes;
};

__host__ __device__ constexpr int group_bytes(GroupSizes z) {
  return 32 + z.src_bytes + z.buf_bytes + 16;
}

GroupSizes group_sizes(int group_warps, int n, int c, int k_out,
                       int buf_cap) {
  const int slots = k_out < group_warps * 32 * 16 ? k_out
                                                  : group_warps * 32 * 16;
  long long rows = k_out < n ? k_out : n;
  long long buf = rows * c < buf_cap ? rows * c : buf_cap;
  if (buf_cap > 0 && buf < c) buf = c;
  return GroupSizes{align16(2 * slots), align16((int)buf)};
}

struct GroupSmem {
  int* warp_tot;
  uint16_t* src;
  int8_t* buf;
  int buf_bytes;
};

__device__ __forceinline__ GroupSmem group_smem(unsigned char* base,
                                                GroupSizes z) {
  GroupSmem s;
  s.warp_tot = reinterpret_cast<int*>(base);
  s.src = reinterpret_cast<uint16_t*>(base + 32);
  s.buf = reinterpret_cast<int8_t*>(base + 32 + z.src_bytes);
  s.buf_bytes = z.buf_bytes;
  return s;
}

// Compact the valid rows among chunks [c_begin, c_end) of one batch row
// into output slots base, base + 1, ... of o (slots at or past k_out are
// counted and not copied).  Returns the segment's valid count; every
// thread of the group must call it.
template <int kGroupWarps, bool kWords>
__device__ int compact_segment(const FlagRow& fr, int c_begin, int c_end,
                               const int8_t* pay, int8_t* o, int c,
                               int k_out, int base, const GroupSmem& sm) {
  constexpr int kG = 32 * kGroupWarps;
  constexpr int kHalfWarps = kG / 16;
  const int t = threadIdx.x & (kG - 1);
  const int hw = t >> 4, hl = t & 15;
  // A warp's runs are short (at most 16 rows at k1), and there the pass
  // through shared memory costs more than the 16-byte stores save: a warp
  // copies its rows straight to the output.
  constexpr bool kDirect = kGroupWarps == 1;
  const int cap = kDirect ? k_out : sm.buf_bytes / c;  // rows per piece
  int seen = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += kG) {
    const int ch = c0 + t;
    const unsigned bits = ch < c_end ? chunk_bits(fr, ch) : 0u;
    int total;
    const int excl = group_scan<kGroupWarps>(__popc(bits), sm.warp_tot,
                                             total);
    const int slot0 = base + seen;
    const int keep = min(max(k_out - slot0, 0), total);
    if (keep > 0) {
      unsigned m = bits;
      for (int s = excl; m != 0u && s < keep; ++s) {
        sm.src[s] = (uint16_t)(16 * t + __ffs(m) - 1);
        m &= m - 1u;
      }
      group_sync<kGroupWarps>();
      const int first = 16 * c0 - fr.lead;  // flag of the round's byte 0
      for (int p0 = 0; p0 < keep; p0 += cap) {
        const int rows = min(cap, keep - p0);
        int8_t* dst = o + (size_t)(slot0 + p0) * c;
        int8_t* img = kDirect ? dst : sm.buf + ((uintptr_t)dst & 15);
        copy_rows<kHalfWarps, kWords>(img, pay, sm.src + p0, first, rows, c,
                                      hw, hl);
        if (!kDirect) {
          group_sync<kGroupWarps>();
          store_run(dst, img, rows * c, t, kG);
          group_sync<kGroupWarps>();
        }
      }
    }
    seen += total;
    group_sync<kGroupWarps>();  // warp_tot and src are rewritten next round
  }
  return seen;
}

// One group (a warp or the block) per batch row, kGroups rows a block.
template <int kGroupWarps, int kGroups, bool kWords>
__global__ void __launch_bounds__(32 * kGroupWarps * kGroups)
compact_rows_kernel(const int8_t* __restrict__ payload,
                    const uint8_t* __restrict__ valid,
                    int8_t* __restrict__ out, int32_t* __restrict__ count,
                    int batch, int n, int c, int k_out, GroupSizes z) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kG = 32 * kGroupWarps;
  const int group = threadIdx.x / kG;
  const int b = blockIdx.x * kGroups + group;
  if (b >= batch) return;  // a whole group: it syncs only itself
  const int t = threadIdx.x & (kG - 1);
  const GroupSmem sm = group_smem(smem + (size_t)group * group_bytes(z), z);
  const FlagRow fr = flag_row(valid, b, n);
  int8_t* o = out + (size_t)b * k_out * c;
  const int cnt = compact_segment<kGroupWarps, kWords>(
      fr, 0, fr.nchunks, payload + (size_t)b * n * c, o, c, k_out, 0, sm);
  const int filled = min(cnt, k_out);
  store_run(o + (size_t)filled * c, nullptr, (k_out - filled) * c, t, kG);
  if (t == 0) count[b] = cnt;
}

// Split layout, launch 1: the valid count of each tile of tile_chunks
// chunks, grid (tiles, B).
__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const uint8_t* __restrict__ valid,
                  int32_t* __restrict__ tile_count, int n, int tile_chunks,
                  int tiles) {
  __shared__ int red[kWarps];
  const int tile = blockIdx.x, b = blockIdx.y;
  const FlagRow fr = flag_row(valid, b, n);
  const int ch = tile * tile_chunks + (int)threadIdx.x;
  const int v = ((int)threadIdx.x < tile_chunks && ch < fr.nchunks)
                    ? __popc(chunk_bits(fr, ch)) : 0;
  const int s = block_sum(v, red);
  if (threadIdx.x == 0) tile_count[(size_t)b * tiles + tile] = s;
}

// Split layout, launch 2: each tile takes its first output slot from the
// earlier tiles' counts, compacts its chunks, and zero-fills its share of
// the output tail; tile 0 writes the count.
template <bool kWords>
__global__ void __launch_bounds__(kThreads)
compact_tiles_kernel(const int8_t* __restrict__ payload,
                     const uint8_t* __restrict__ valid,
                     int8_t* __restrict__ out, int32_t* __restrict__ count,
                     const int32_t* __restrict__ tile_count, int n, int c,
                     int k_out, int tile_chunks, int tiles, GroupSizes z) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kWarps];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int32_t* tc = tile_count + (size_t)b * tiles;
  int before = 0, all = 0;
  for (int i = threadIdx.x; i < tiles; i += kThreads) {
    const int x = tc[i];
    all += x;
    before += i < tile ? x : 0;
  }
  before = block_sum(before, red);
  const int total = block_sum(all, red);

  const GroupSmem sm = group_smem(smem, z);
  const FlagRow fr = flag_row(valid, b, n);
  int8_t* o = out + (size_t)b * k_out * c;
  const int c_begin = min(tile * tile_chunks, fr.nchunks);
  const int c_end = min(c_begin + tile_chunks, fr.nchunks);
  compact_segment<kWarps, kWords>(fr, c_begin, c_end,
                                  payload + (size_t)b * n * c, o, c, k_out,
                                  before, sm);
  const int filled = min(total, k_out);
  const int per = (k_out + tiles - 1) / tiles;
  const int z0 = max(filled, tile * per);
  const int z1 = min(k_out, (tile + 1) * per);
  store_run(o + (size_t)z0 * c, nullptr, (z1 - z0) * c, threadIdx.x,
            kThreads);
  if (tile == 0 && threadIdx.x == 0) count[b] = total;
}

// Dynamic shared memory above 48 KB needs the kernel's consent.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Plan {
  bool split;
  int tile_chunks;
  int tiles;
};

Plan plan(int batch, int n) {
  Plan p{false, 0, 0};
  if (batch < kSplitMaxRows && n >= kSplitMinN) {
    const long long nchunks = (n + 30LL) / 16;  // the most any row has
    long long want = (nchunks * batch + kSplitMaxRows - 1) / kSplitMaxRows;
    want = want < 4 ? 4 : (want > kThreads ? kThreads : want);
    p.split = true;
    p.tile_chunks = (int)want;
    p.tiles = (int)((nchunks + want - 1) / want);
  }
  return p;
}

template <int kGroupWarps, int kGroups, bool kWords>
cudaError_t launch_rows(const void* payload, const void* valid, void* out,
                        void* count, int batch, int n, int c, int k_out,
                        int buf_cap, cudaStream_t stream) {
  const GroupSizes z = group_sizes(kGroupWarps, n, c, k_out, buf_cap);
  const int smem = kGroups * group_bytes(z);
  auto kernel = compact_rows_kernel<kGroupWarps, kGroups, kWords>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(batch + kGroups - 1) / kGroups, 32 * kGroupWarps * kGroups, smem,
           stream>>>(
      (const int8_t*)payload, (const uint8_t*)valid, (int8_t*)out,
      (int32_t*)count, batch, n, c, k_out, z);
  return cudaGetLastError();
}

template <bool kWords>
cudaError_t launch_split(const void* payload, const void* valid, void* out,
                         void* count, void* scratch, int batch, int n, int c,
                         int k_out, int buf_cap, const Plan& p,
                         cudaStream_t stream) {
  const GroupSizes z = group_sizes(kWarps, p.tile_chunks * 16, c, k_out,
                                   buf_cap);
  const int smem = group_bytes(z);
  auto kernel = compact_tiles_kernel<kWords>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.tiles, batch);
  tile_count_kernel<<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)valid, (int32_t*)scratch, n, p.tile_chunks, p.tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const int8_t*)payload, (const uint8_t*)valid, (int8_t*)out,
      (int32_t*)count, (const int32_t*)scratch, n, c, k_out, p.tile_chunks,
      p.tiles, z);
  return cudaGetLastError();
}

}  // namespace

// int32 entries of the tile-count scratch that compact_rows_launch needs
// for this shape (0: no scratch).
extern "C" int compact_rows_scratch_ints(int batch, int n) {
  const Plan p = plan(batch, n);
  return p.split ? p.tiles * batch : 0;
}

extern "C" int compact_rows_launch(const void* payload, const void* valid,
                                   void* out, void* count, void* scratch,
                                   int batch, int n, int c, int k_out,
                                   void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  if (c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool words = c % 4 == 0 && (uintptr_t)payload % 4 == 0;
  const int block_buf = c > kBlockBufBytes ? align16(c) : kBlockBufBytes;
  const Plan p = plan(batch, n);
  cudaError_t err;
  if (p.split) {
    err = words ? launch_split<true>(payload, valid, out, count, scratch,
                                     batch, n, c, k_out, block_buf, p, s)
                : launch_split<false>(payload, valid, out, count, scratch,
                                      batch, n, c, k_out, block_buf, p, s);
  } else if (n <= kWarpRowMaxN) {
    constexpr int kG = kWarpRowsPerBlock;
    err = words ? launch_rows<1, kG, true>(payload, valid, out, count, batch,
                                           n, c, k_out, 0, s)
                : launch_rows<1, kG, false>(payload, valid, out, count, batch,
                                            n, c, k_out, 0, s);
  } else if (n < kWideRowMinN) {
    err = words ? launch_rows<4, 1, true>(payload, valid, out, count, batch,
                                          n, c, k_out, block_buf, s)
                : launch_rows<4, 1, false>(payload, valid, out, count, batch,
                                           n, c, k_out, block_buf, s);
  } else {
    err = words ? launch_rows<8, 1, true>(payload, valid, out, count, batch,
                                          n, c, k_out, block_buf, s)
                : launch_rows<8, 1, false>(payload, valid, out, count, batch,
                                           n, c, k_out, block_buf, s);
  }
  return (int)err;
}
