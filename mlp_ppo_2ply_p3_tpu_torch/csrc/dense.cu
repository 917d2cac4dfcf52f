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
// kept rows up to it; blocks past it do no work, and a graph captures the
// launches.  Per kept row the wildbg trunk (300, 250, 200) is 126,200
// multiply-adds forward and twice that backward, so the products bound it.
//
// The products are exact split products on the tensor cores.  Both operands
// of a dense layer are float32 numbers that bf16 does not hold, so each is
// split into three bf16 limbs x = x0 + x1 + x2, each rounded to nearest from
// what the ones before leave (ops/afterstate.py::split_bf16): the three hold
// float32's 24 significant bits exactly.  A float32 product becomes the six
// limb products x_i w_j with i + j <= 2, each exact in float32; the three
// left out are under 2^-23 of |x w|, float32's own rounding.  They run as
// wgmma (bf16 in, float32 out) and go smallest first into a fragment that the
// first one overwrites; that fragment is added to the running sum in float32
// once a k-step of 16, so the tensor core's truncation reaches one 16-term
// partial only.  TF32 (10 bits) would be 1,000 times further off.
//
// - Tiles follow the widths: K is padded to a multiple of 16 (wgmma's depth)
//   and N to 8, with zeros, which is exact and covers widths of 1.  M is 64
//   rows a warpgroup.  A (the rows) comes from registers, split as it is
//   read; B (the weights, or dpre in the weight gradient) as limbs in shared
//   memory.  Each product kernel takes one fragment width W (a template
//   parameter: ptxas serializes the wgmma of a kernel that mixes widths), so
//   a layer runs as one launch of equal chunks where a width of 32 to 64
//   divides its padded N (200 = 5 x 40), else as chunks of 64 and a launch of
//   the rest (300 columns cost 256 + 48).
// - dense_forward_kernel_split_weights: once a call, every layer's weights
//   into their three limbs in global memory, padded, in the 8 x 8 core-matrix
//   layout (K-major, no swizzle) that the wgmma descriptors read: W_l for the
//   forward, W_l^T for the backward.  A few microseconds; it carries the
//   forward's name so that what counts the dense layers' kernels counts it.
// - dense_forward_kernel<W>: one layer (a column range of it), a persistent
//   grid of 256 threads (two warpgroups); a block takes tiles of 128 kept
//   rows, a warpgroup 64 of them: the layer's input rows by cp.async into
//   shared memory as float32, then its limbs in stages of one chunk x 64 k by
//   cp.async (two stages in flight), both warpgroups reading each stage, so
//   the limbs cross from L2 once a 128 rows.  Bias and ReLU in registers,
//   h_l into act[l].  dense_forward_kernel_head: the head on the CUDA cores
//   (four lanes a row, a fixed order of sums) and the epilogue.
// - dense_backward_kernel_head: a fixed number of blocks (a number of the
//   shapes, never of the card), each a contiguous range of tiles: the head
//   again from the saved h_L, dz, the head's weight and bias gradients into
//   the block's partials, and dpre_L = W_head^T dz [h_L > 0].  Then
//   dense_backward_kernel<W>, layer by layer, dpre_{l-1} = W_l^T dpre_l
//   [h_{l-1} > 0] as the forward's products with W_l^T's limbs, each into
//   dpre[l-1] (dpre[0], fc1's, is what csrc/afterstate.cu's deep backward
//   takes).
// - dense_wgrad_kernel<W>: dW_l and db_l as one product over the kept rows,
//   dpre_l^T [h_{l-1}, 1]: tiles of 128 inputs (a warpgroup 64, wgmma's M) x
//   W outputs, split into a fixed number of row slices, each slice's partial
//   into scratch.  Stages of 32 rows come by cp.async three deep as float32
//   ([h, 1] and dpre); [h, 1] is split as A fragments in registers and dpre
//   into limbs in shared memory (B, the rows its K).
// - dense_reduce_kernel: every gradient entry, the partials summed in slice
//   (block) order.  No float sum uses an atomic and the tensor cores sum in a
//   fixed order, so the gradients are the same bits on every run and card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // two warpgroups
constexpr int kRows = 128;          // kept rows a tile, 64 a warpgroup
constexpr int kMaxWidth = 320;      // widest layer
constexpr int kLd = 328;            // floats between two rows of a tile in
                                    // smem: >= 320, 8 mod 32, so the float2
                                    // fragment reads meet no bank conflict
constexpr int kMaxLayers = 8;       // dense layers after fc1
constexpr int kMaxHeads = 8;        // head outputs
constexpr int kChunk = 64;          // output columns at most a chunk
constexpr int kKS = 64;             // k a stage (four k-steps of 16)
constexpr int kLimbStage = kChunk * kKS * 2;   // bytes of one limb's stage
constexpr int kGroupBytes = kKS / 8 * 128;     // between two groups of 8 n
constexpr int kXT = 128;            // wgrad: inputs a tile
constexpr int kHLd = kXT + 4;       // wgrad: floats between two [h, 1] rows
constexpr int kDLd = kChunk + 4;    // wgrad: floats between two dpre rows
constexpr int kWS = 32;             // wgrad: rows a stage (two k-steps)
constexpr int kWLimb = kChunk * kWS * 2;       // wgrad: bytes of a limb
constexpr int kDepth = 3;           // wgrad: stages in flight
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
  float* act[kMaxLayers];           // h_{l+1} (capacity, ld[l+1])
  float* dpre[kMaxLayers + 1];      // dpre_l (capacity, ld[l])
  const int* elem;
  const int* count;
  const float* grad;                // (rows m) backward
  float* out;                       // (rows m) forward
  float* part_rows;                 // (row blocks, heads (width[L] + 1))
  float* part_w;                    // (slices, sum width[l] (width[l-1] + 1))
  float* dflat;                     // the gradients, parameter order
  // the limbs of W_{l+1} (forward) or W_{l+1}^T (backward): a (rows8[l],
  // cols16[l]) matrix a limb, three limbs in a row from limbs + loff[l]
  unsigned char* limbs;
  size_t loff[kMaxLayers];
  int rows8[kMaxLayers];
  int cols16[kMaxLayers];
};

constexpr size_t kTileFloats = (size_t)kRows * kLd;           // 41,984
constexpr size_t kRingBytes = 2ull * 3 * kLimbStage;          // 49,152
constexpr size_t kHeadFloats = (size_t)kMaxHeads * (kMaxWidth + 1);
constexpr size_t kSmemRows = 4 * kTileFloats + kRingBytes;      // 217,088
constexpr size_t kSmemHead = 4 * kTileFloats;                   // 167,936
constexpr size_t kSmemHeadBackward =
    kSmemHead + 4 * (kHeadFloats + kMaxHeads * kRows);          // 182,304
constexpr size_t kHsBytes = 4ull * kDepth * kWS * kHLd;         // 50,688
constexpr size_t kDsBytes = 4ull * kDepth * kWS * kDLd;         // 26,112
constexpr size_t kSmemWgrad = kHsBytes + kDsBytes + 2ull * 3 * kWLimb;

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Writes by threads (and cp.async) become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes from src, or (bytes 0) zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) = p0 + p1 + p2 in bf16 pairs (x in the low half), each part rounded
// to nearest from what the ones before leave.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& p0,
                                           uint32_t& p1, uint32_t& p2) {
  __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
  float2 f = __bfloat1622float2(b);
  p0 = bits(b);
  x -= f.x;
  y -= f.y;
  b = __floats2bfloat162_rn(x, y);
  f = __bfloat1622float2(b);
  p1 = bits(b);
  x -= f.x;
  y -= f.y;
  p2 = bits(__floats2bfloat162_rn(x, y));
}

// A shared-memory matrix descriptor of a staged limb at addr: 8 x 8 core
// matrices, 128 bytes apart along K, sbo bytes between groups of 8 n.
__device__ __forceinline__ uint64_t limb_desc(unsigned addr, unsigned sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
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

// Pins a fragment's registers in the order of the wgmma statements: the
// compiler moves no read or write of them across this point (after a wait,
// before a wgmma.fence), so ptxas finds the wgmma pipeline as written.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_limbs(uint32_t (&a)[3][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][i])::"memory");
  }
}

// d[0 .. N/2) (+)= A B^T for a warpgroup: A 64 x 16 bf16 in registers (the
// fragment of mma.m16n8k16's A, a warp 16 rows), B N x 16 bf16 K-major in
// shared memory (descriptor db), d 64 x N float32; scale 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rs<24>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rs<56>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale));
}

// t = the six limb products of a k-step, smallest first, t overwritten:
// a[i] the A fragment's limb i, B's limb j at bs + j lb (sbo bytes between
// its groups of 8 n).
template <int W>
__device__ __forceinline__ void six_products(float (&t)[32],
                                             const uint32_t (&a)[3][4],
                                             unsigned bs, unsigned lb,
                                             unsigned sbo) {
  const uint64_t b0 = limb_desc(bs, sbo);
  const uint64_t b1 = limb_desc(bs + lb, sbo);
  const uint64_t b2 = limb_desc(bs + 2 * lb, sbo);
  wgmma_rs<W>(t, a[2], b0, 0);
  wgmma_rs<W>(t, a[1], b1, 1);
  wgmma_rs<W>(t, a[0], b2, 1);
  wgmma_rs<W>(t, a[1], b0, 1);
  wgmma_rs<W>(t, a[0], b1, 1);
  wgmma_rs<W>(t, a[0], b0, 1);
}

template <int W>
__device__ __forceinline__ void add_fragment(float (&acc)[32],
                                             float (&t)[32]) {
  fence_regs<W>(t);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] += t[i];
}

// The A fragment of a k-step at k, limbs a[0..2]: rows 16 w + g and + 8 of
// the warpgroup's 64 (w its warp, g = lane / 4), columns k + 2 (lane % 4) +
// {0, 1} and + 8, from a row-major float32 tile.
struct RowA {
  const float* in;                  // the warpgroup's first row
  __device__ __forceinline__ void operator()(int k,
                                             uint32_t (&a)[3][4]) const {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const float* p0 = in + (16 * warp + (lane >> 2)) * kLd + k + 2 * (lane & 3);
    const float* p1 = p0 + 8 * kLd;
    const float2 x00 = *reinterpret_cast<const float2*>(p0);
    const float2 x10 = *reinterpret_cast<const float2*>(p1);
    const float2 x01 = *reinterpret_cast<const float2*>(p0 + 8);
    const float2 x11 = *reinterpret_cast<const float2*>(p1 + 8);
    split_pair(x00.x, x00.y, a[0][0], a[1][0], a[2][0]);
    split_pair(x10.x, x10.y, a[0][1], a[1][1], a[2][1]);
    split_pair(x01.x, x01.y, a[0][2], a[1][2], a[2][2]);
    split_pair(x11.x, x11.y, a[0][3], a[1][3], a[2][3]);
  }
};

// The same fragment of the transposed tile: A[m][k] = hs[k][x + m], hs the
// staged rows (k) of [h, 1] with kHLd floats between rows.
struct ColA {
  const float* hs;
  int x;
  __device__ __forceinline__ void operator()(int k,
                                             uint32_t (&a)[3][4]) const {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const float* p = hs + (k + 2 * (lane & 3)) * kHLd + x + 16 * warp +
                     (lane >> 2);
    split_pair(p[0], p[kHLd], a[0][0], a[1][0], a[2][0]);
    split_pair(p[8], p[kHLd + 8], a[0][1], a[1][1], a[2][1]);
    split_pair(p[8 * kHLd], p[9 * kHLd], a[0][2], a[1][2], a[2][2]);
    split_pair(p[8 * kHLd + 8], p[9 * kHLd + 8], a[0][3], a[1][3], a[2][3]);
  }
};

// One stage (steps <= 4 k-steps of 16 at k) of a warpgroup's W-column
// product into acc (zeroed first where `first`), B's limbs staged at bs
// (limb stride lb, sbo bytes between groups of 8 n): a k-step at a time, its
// A fragment loaded and split, its six products issued as one wgmma group
// into a fragment that the first overwrites, then added to acc once they are
// done, so the tensor core's truncation reaches one 16-term partial (over a
// 64-k stage it read 1.2e-3 past the deep cell's first_grad_gap limit on a
// seed).  Where `last`, epi.run<W>(acc, c0) then takes the sums.
template <int W, class A, class Epi>
__device__ __forceinline__ void stage_products(const A& load, int k,
                                               int steps, unsigned bs,
                                               unsigned lb, unsigned sbo,
                                               bool first, bool last,
                                               float (&acc)[32], int c0,
                                               const Epi& epi) {
  if (first) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
  }
  float t[32];
#pragma unroll
  for (int s = 0; s < kKS / 16; ++s) {
    if (s < steps) {
      uint32_t a[3][4];
      load(k + 16 * s, a);
      fence_limbs(a);
      fence_regs<W>(t);
      wgmma_fence();
      six_products<W>(t, a, bs + 256 * s, lb, sbo);
      wgmma_commit();
      wgmma_wait<0>();
      add_fragment<W>(acc, t);
    }
  }
  if (last) epi.template run<W>(acc, c0);
}

// One layer's product as the row kernels run it: (128 x the columns) = in
// (128 x k16, the tile, row-major float32 in shared memory) times B^T, B
// the layer's (rows8, k16) limbs in global memory.  Both warpgroups (rows
// 0-63 and 64-127) walk the same stages: stage t is chunk t / nks's k-range
// t % nks, staged in ring buffer t & 1 while the other is read.  Every
// kernel that runs it takes one chunk width W (column_ranges).
struct Layer {
  const float* in;
  const unsigned char* limbs;       // limb 0; limbs 1 and 2 follow
  size_t lbytes;                    // bytes of a limb, rows8 k16 2
  int k16;
};

// The limbs of columns [c0, c0 + W) x k [k0, k0 + 64) into ring buffer buf:
// 16-byte pieces (limb, group of 8 n, core matrix along k, piece), a warp's
// 32 consecutive ones contiguous in global memory.
template <int W>
__device__ __forceinline__ void stage_limbs(const Layer& L,
                                            unsigned char* ring, int c0,
                                            int k0, int buf) {
  const int nkc = min(kKS, L.k16 - k0) / 8;
  for (int idx = threadIdx.x; idx < 3 * 8 * 8 * 8; idx += kThreads) {
    const int piece = idx & 7, kc = (idx >> 3) & 7, gi = (idx >> 6) & 7;
    const int p = idx >> 9;
    if (8 * gi >= W || kc >= nkc) continue;
    const unsigned char* src =
        L.limbs + p * L.lbytes +
        ((size_t)(c0 / 8 + gi) * (L.k16 / 8) + k0 / 8 + kc) * 128 + piece * 16;
    unsigned char* dst = ring + (size_t)(buf * 3 + p) * kLimbStage +
                         gi * kGroupBytes + kc * 128 + piece * 16;
    cp_async16(dst, src);
  }
}

// Columns [cb, cb + nch W) of the layer's product for the tile; each chunk's
// sums to epi.  Ends with a block barrier.
template <int W, class Epi>
__device__ void layer_product(const Layer& L, int cb, int nch,
                              unsigned char* ring, const Epi& epi) {
  const int wg = threadIdx.x >> 7;
  const int nks = (L.k16 + kKS - 1) / kKS;
  const int T = nch * nks;
  const unsigned ring_s = smem_addr(ring);
  const RowA load{L.in + wg * 64 * kLd};
  float acc[32];
  stage_limbs<W>(L, ring, cb, 0, 0);
  cp_async_commit();
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    if (t + 1 < T) {
      stage_limbs<W>(L, ring, cb + W * ((t + 1) / nks),
                     ((t + 1) % nks) * kKS, buf ^ 1);
    }
    cp_async_commit();   // (empty at the end: one group a stage)
    cp_async_wait<1>();
    fence_async_shared();
    __syncthreads();
    const int j = t / nks, ks = t - j * nks;
    const int k = ks * kKS;
    stage_products<W>(load, k, min(kKS, L.k16 - k) / 16,
                      ring_s + (unsigned)(buf * 3 * kLimbStage), kLimbStage,
                      kGroupBytes, ks == 0, ks == nks - 1, acc, cb + W * j,
                      epi);
    __syncthreads();
  }
}

// The tile row and column of a thread's fragment entries: acc[4 j + 2 h + e]
// is row 16 w + g + 8 h of its warpgroup's 64, column 8 j + 2 t + e (t =
// lane % 4).
__device__ __forceinline__ int frag_row(int h) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x & 3); }
__device__ __forceinline__ int tile_row(int h) {
  return 64 * (threadIdx.x >> 7) + frag_row(h);
}

// The forward's epilogue: relu(acc + b) into the layer's activations (the
// bias loaded first, so its loads overlap).
struct ForwardEpi {
  const float* bias;
  float* dst;
  int ld, n, g0, nrows;
  template <int W>
  __device__ __forceinline__ void run(const float (&acc)[32], int c0) const {
    float2 b[W / 8];
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = c0 + 8 * j + frag_col();
      b[j] = make_float2(c < n ? __ldg(bias + c) : 0.0f,
                         c + 1 < n ? __ldg(bias + c + 1) : 0.0f);
    }
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = c0 + 8 * j + frag_col();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile_row(h);
        if (row >= nrows || c >= n) continue;
        const float v0 = fmaxf(acc[4 * j + 2 * h] + b[j].x, 0.0f);
        const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + b[j].y, 0.0f);
        float* p = dst + (size_t)(g0 + row) * ld + c;
        if (c + 1 < n) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          *p = v0;
        }
      }
    }
  }
};

// The backward's epilogue: acc where h_{l-1} > 0, into dpre[l-1] (every
// mask value loaded before any store, so the loads overlap).
struct BackwardEpi {
  const float* act;
  float* dst;
  int ld, n, g0, nrows;
  template <int W>
  __device__ __forceinline__ void run(const float (&acc)[32], int c0) const {
    float2 hv[W / 8][2];
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = c0 + 8 * j + frag_col();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile_row(h);
        const size_t at = (size_t)(g0 + row) * ld + c;
        hv[j][h] = make_float2(0.0f, 0.0f);
        if (row < nrows && c < n) {
          hv[j][h] = c + 1 < n ? __ldg(reinterpret_cast<const float2*>(act + at))
                               : make_float2(__ldg(act + at), 0.0f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = c0 + 8 * j + frag_col();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile_row(h);
        if (row >= nrows || c >= n) continue;
        const float d0 = hv[j][h].x > 0.0f ? acc[4 * j + 2 * h] : 0.0f;
        const float d1 = hv[j][h].y > 0.0f ? acc[4 * j + 2 * h + 1] : 0.0f;
        float* p = dst + (size_t)(g0 + row) * ld + c;
        if (c + 1 < n) {
          *reinterpret_cast<float2*>(p) = make_float2(d0, d1);
        } else {
          *p = d0;
        }
      }
    }
  }
};

// A tile of rows [g0, g0 + nrows) of src (capacity, ld), width K, into the
// row-major buffer dst: columns [K, round16(K)) and rows past nrows zero.
// Every 16-byte piece at once by cp.async (zeros where it lies past the
// rows or the width), then the piece that holds column K cleared past it.
// Ends with a block barrier.
__device__ void load_tile(const float* __restrict__ src, int ld, int K,
                          int g0, int nrows, float* dst) {
  const int q4 = round16(K) / 4;
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < kRows; row += kThreads / 32) {
    for (int q = lane; q < q4; q += 32) {
      const int k = 4 * q;
      const bool live = row < nrows && k < K;
      cp_async16(dst + row * kLd + k,
                 live ? src + (size_t)(g0 + row) * ld + k : src,
                 live ? 16 : 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int tail = (K + 3) / 4 * 4 - K;   // columns of K's piece past K
  for (int idx = threadIdx.x; idx < kRows * tail; idx += kThreads) {
    dst[(idx / tail) * kLd + K + idx % tail] = 0.0f;
  }
  __syncthreads();
}

// The head's z of tile row `row` (each of the row's four lanes, tid % 4,
// ends with all of them): lane p sums k = p, p + 4, ..., then the four
// lanes' sums meet by two shuffles.  hl is h_L, row-major.
__device__ __forceinline__ void head_z(const Net& a, const float* hl, int row,
                                       float (&z)[kMaxHeads]) {
  const int part = threadIdx.x & 3;
  const int K = a.width[a.layers];
#pragma unroll
  for (int j = 0; j < kMaxHeads; ++j) {
    float s = 0.0f;
    if (j < a.heads) {
      const float* wj = a.wh + (size_t)j * K;
      for (int k = part; k < K; k += 4) {
        s = fmaf(__ldg(wj + k), hl[row * kLd + k], s);
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

__host__ __device__ __forceinline__ size_t limb_bytes(const Net& a, int l) {
  return (size_t)a.rows8[l] * a.cols16[l] * 2;
}

// Every layer's weights (kT: transposed) into their three limbs, padded with
// zeros: entry (n, k) of limb p of layer l, n < rows8[l] and k < cols16[l],
// at limbs + loff[l] + p limb_bytes + 2 (((n / 8) (cols16 / 8) + k / 8) 64 +
// (n % 8) 8 + k % 8).  A thread takes the pair (n, k), (n, k + 1); the
// transposed form reads W's rows k and k + 1 along n, so every read is
// coalesced either way.
template <bool kT>
__global__ void dense_forward_kernel_split_weights(Net a, int pairs) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += gridDim.x * blockDim.x) {
    int rest = i, l = 0;
    for (; l < a.layers - 1; ++l) {
      const int layer_pairs = a.rows8[l] * a.cols16[l] / 2;
      if (rest < layer_pairs) break;
      rest -= layer_pairs;
    }
    const int R = a.rows8[l], C = a.cols16[l];
    const int nw = a.width[l + 1], kw = a.width[l];   // W (nw, kw)
    const float* w = a.w[l];
    int n, k;
    float v0 = 0.0f, v1 = 0.0f;
    if (kT) {   // B[n][k] = W[k][n]
      n = rest % R;
      k = 2 * (rest / R);
      if (n < kw && k < nw) v0 = w[(size_t)k * kw + n];
      if (n < kw && k + 1 < nw) v1 = w[(size_t)(k + 1) * kw + n];
    } else {
      k = 2 * (rest % (C / 2));
      n = rest / (C / 2);
      if (n < nw && k < kw) v0 = w[(size_t)n * kw + k];
      if (n < nw && k + 1 < kw) v1 = w[(size_t)n * kw + k + 1];
    }
    uint32_t p0, p1, p2;
    split_pair(v0, v1, p0, p1, p2);
    const size_t e = ((size_t)(n / 8) * (C / 8) + k / 8) * 64 + (n % 8) * 8 +
                     k % 8;
    uint32_t* dst = reinterpret_cast<uint32_t*>(a.limbs + a.loff[l]);
    const size_t step = limb_bytes(a, l) / 4;
    dst[e / 2] = p0;
    dst[step + e / 2] = p1;
    dst[2 * step + e / 2] = p2;
  }
}

// The layer l (0-based) product of the limbs: its limbs and the tile it
// multiplies.
__device__ __forceinline__ Layer layer_of(const Net& a, int l,
                                          const float* in) {
  return Layer{in, a.limbs + a.loff[l], limb_bytes(a, l), a.cols16[l]};
}

// The forward of layer l (0-based, W_{l+1}), columns [cb, cb + nch W) of
// its output: tiles blockIdx.x, blockIdx.x + gridDim.x, ... of 128 kept
// rows, the input h_l (h1, or act[l-1]) into shared memory, relu(W h + b)
// into act[l].
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    dense_forward_kernel(Net a, int l, int cb, int nch) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* tile_in = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + 4 * kTileFloats;
  const int count = *a.count;
  const int tiles = (count + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * kRows, nrows = min(kRows, count - g0);
    load_tile(l == 0 ? a.h1 : a.act[l - 1], a.ld[l], a.width[l], g0, nrows,
              tile_in);
    const ForwardEpi epi{a.b[l], a.act[l], a.ld[l + 1], a.width[l + 1], g0,
                         nrows};
    layer_product<W>(layer_of(a, l, tile_in), cb, nch, ring, epi);
  }
}

// The head and the epilogue: tiles of h_L, out[elem[g]] = sign y.
__global__ void __launch_bounds__(kThreads, 1)
    dense_forward_kernel_head(Net a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* tile_in = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, L = a.layers;
  const int count = *a.count;
  const int tiles = (count + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * kRows, nrows = min(kRows, count - g0);
    load_tile(a.act[L - 1], a.ld[L], a.width[L], g0, nrows, tile_in);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 64 * half + (tid >> 2);
      float z[kMaxHeads], p[kMaxHeads];
      head_z(a, tile_in, row, z);
      const float y = head_y(a, z, p);
      if ((tid & 3) == 0 && row < nrows) a.out[a.elem[g0 + row]] = a.sign * y;
    }
    __syncthreads();   // the tile is the next tile's
  }
}

// The backward's head: dz, the head's gradients into the block's partials
// and dpre_L = W_head^T dz [h_L > 0] into dpre[L].  Block b takes tiles
// [T b / G, T (b + 1) / G).
__global__ void __launch_bounds__(kThreads, 1)
    dense_backward_kernel_head(Net a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* tile_in = reinterpret_cast<float*>(smem);
  float* hsum = tile_in + kTileFloats;
  float* dzs = hsum + kHeadFloats;            // [J][128]
  const int tid = threadIdx.x;
  const int L = a.layers, J = a.heads, KL = a.width[L];
  const int nhead = J * (KL + 1);
  for (int o = tid; o < nhead; o += kThreads) hsum[o] = 0.0f;
  const int count = *a.count;
  const long long tiles = (count + kRows - 1) / kRows;
  const int t0 = (int)(tiles * blockIdx.x / gridDim.x);
  const int t1 = (int)(tiles * (blockIdx.x + 1) / gridDim.x);
  for (int tile = t0; tile < t1; ++tile) {
    const int g0 = tile * kRows, nrows = min(kRows, count - g0);
    load_tile(a.act[L - 1], a.ld[L], KL, g0, nrows, tile_in);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 64 * half + (tid >> 2);
      float z[kMaxHeads], p[kMaxHeads];
      head_z(a, tile_in, row, z);
      const float y = head_y(a, z, p);
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
        for (int r = 0; r < kRows; ++r) s = fmaf(dz[r], tile_in[r * kLd + k], s);
      } else {
        for (int r = 0; r < kRows; ++r) s += dz[r];
      }
      hsum[o] += s;
    }
    // dpre_L = W_head^T dz where h_L > 0, a warp a row at a time
    float* dst = a.dpre[L];
    for (int row = tid >> 5; row < nrows; row += kThreads / 32) {
      for (int k = tid & 31; k < KL; k += 32) {
        float d = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxHeads; ++j) {
          if (j < J) d = fmaf(__ldg(a.wh + (size_t)j * KL + k),
                              dzs[j * kRows + row], d);
        }
        if (!(tile_in[row * kLd + k] > 0.0f)) d = 0.0f;
        dst[(size_t)(g0 + row) * a.ld[L] + k] = d;
      }
    }
    __syncthreads();   // the tile and dz are the next tile's
  }
  float* slab = a.part_rows + (size_t)blockIdx.x * nhead;
  for (int o = tid; o < nhead; o += kThreads) slab[o] = hsum[o];
}

// The backward of layer l (1-based): columns [cb, cb + nch W) of dpre_{l-1}
// = W_l^T dpre_l [h_{l-1} > 0], tiles of 128 kept rows as the forward's.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    dense_backward_kernel(Net a, int l, int cb, int nch) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* tile_in = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + 4 * kTileFloats;
  const int count = *a.count;
  const int tiles = (count + kRows - 1) / kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int g0 = tile * kRows, nrows = min(kRows, count - g0);
    load_tile(a.dpre[l], a.ld[l], a.width[l], g0, nrows, tile_in);
    const BackwardEpi epi{l >= 2 ? a.act[l - 2] : a.h1, a.dpre[l - 1],
                          a.ld[l - 1], a.width[l - 1], g0, nrows};
    layer_product<W>(layer_of(a, l - 1, tile_in), cb, nch, ring, epi);
  }
}

// The wgrad tile's partial sums into slice s's slab: acc[4 j + 2 h + e] is
// input x + frag_row(h), output c0 + 8 j + frag_col() + e.
struct WgradEpi {
  float* part;
  int x, K, N;
  template <int W>
  __device__ __forceinline__ void run(const float (&acc)[32], int c0) const {
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int xi = x + frag_row(h), y = c0 + 8 * j + frag_col() + e;
          if (xi <= K && y < N) {
            part[(size_t)y * (K + 1) + xi] = acc[4 * j + 2 * h + e];
          }
        }
      }
    }
  }
};

// dW_l and db_l, (width[l], width[l-1] + 1) with the bias last, at off in
// each slice's slab: block (x, s) sums inputs [128 (x % xt), + 128) x
// outputs [cb + W (x / xt), + W) over row slice s, rows [count s / S, count
// (s + 1) / S), in stages of 32 rows: [h, 1]'s 128 inputs (A, split as it is
// read) and dpre's W outputs (B, split into limbs once staged), both as
// float32 rows by cp.async, kDepth stages in flight.  (Two blocks an SM
// cap it at 128 registers, and ptxas then spills.)
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    dense_wgrad_kernel(Net a, int l, int cb, size_t off) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);                // [3][32][kHLd]
  float* ds = reinterpret_cast<float*>(smem + kHsBytes);     // [3][32][kDLd]
  uint32_t* lb = reinterpret_cast<uint32_t*>(smem + kHsBytes + kDsBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7;
  const int K = a.width[l - 1], N = a.width[l];
  const int xt = (K + 1 + kXT - 1) / kXT;
  const int x0 = kXT * (blockIdx.x % xt), y0 = cb + W * (blockIdx.x / xt);
  const float* h = l >= 2 ? a.act[l - 2] : a.h1;
  const int ldh = a.ld[l - 1];
  const float* d = a.dpre[l];
  const int ldd = a.ld[l];
  const long long count = *a.count;
  const int r0 = (int)(count * blockIdx.y / a.slices);
  const int r1 = (int)(count * (blockIdx.y + 1) / a.slices);
  // an empty slice runs one stage of zero rows: its partial is exact zeros
  const int stages = max(1, (r1 - r0 + kWS - 1) / kWS);
  // stage s's rows into ring slot s % kDepth: 32 rows x 128 inputs and 32 x
  // W outputs in 16-byte pieces, zeros past the slice or past the widths
  // (the piece holding column K, or N, is fixed once it has landed)
  auto issue = [&](int s) {
    if (s < stages) {
      const int rr = r0 + s * kWS;
      float* hb = hs + (s % kDepth) * kWS * kHLd;
      for (int idx = tid; idx < kWS * (kXT / 4); idx += kThreads) {
        const int r = idx >> 5, x = x0 + 4 * (idx & 31), row = rr + r;
        const bool live = row < r1 && x < K;
        cp_async16(hb + r * kHLd + 4 * (idx & 31),
                   live ? h + (size_t)row * ldh + x : h, live ? 16 : 0);
      }
      float* db = ds + (s % kDepth) * kWS * kDLd;
      for (int idx = tid; idx < kWS * (W / 4); idx += kThreads) {
        const int r = idx / (W / 4), y = y0 + 4 * (idx % (W / 4));
        const int row = rr + r;
        const bool live = row < r1 && y < N;
        cp_async16(db + r * kDLd + 4 * (idx % (W / 4)),
                   live ? d + (size_t)row * ldd + y : d, live ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // stage s landed: [h, 1] past K fixed (1 at K on the slice's rows, else
  // 0) and dpre's pairs of rows split into limbs, words (outputs u, rows 2 p
  // and 2 p + 1) of the core-matrix layout, a warp 8 outputs x 8 rows at a
  // time, into limb buffer s & 1
  auto prepare = [&](int s) {
    const int rr = r0 + s * kWS;
    float* hb = hs + (s % kDepth) * kWS * kHLd;
    if (x0 <= K && K < x0 + kXT) {
      const int xe = min(x0 + kXT, (K + 4) & ~3);
      for (int idx = tid; idx < kWS * (xe - K); idx += kThreads) {
        const int r = idx / (xe - K), x = K + idx % (xe - K);
        hb[r * kHLd + x - x0] = x == K && rr + r < r1 ? 1.0f : 0.0f;
      }
    }
    const float* db = ds + (s % kDepth) * kWS * kDLd;
    uint32_t* lbuf = lb + (s & 1) * 3 * (kWLimb / 4);
#pragma unroll
    for (int q = 0; q < kWS / 8; ++q) {
      const int wi = warp + 8 * q, u = 8 * (wi & 7) + (lane & 7);
      if (u >= W) continue;
      const int rp = 4 * (wi >> 3) + (lane >> 3);
      const bool live = y0 + u < N;
      const float v0 = live ? db[2 * rp * kDLd + u] : 0.0f;
      const float v1 = live ? db[(2 * rp + 1) * kDLd + u] : 0.0f;
      uint32_t p0, p1, p2;
      split_pair(v0, v1, p0, p1, p2);
      const int word = (wi & 7) * (kWS / 8 * 32) + (wi >> 3) * 32 +
                       (lane & 7) * 4 + (lane >> 3);
      lbuf[word] = p0;
      lbuf[kWLimb / 4 + word] = p1;
      lbuf[kWLimb / 2 + word] = p2;
    }
    fence_async_shared();
  };
  size_t total = 0;   // a slice's slab: sum width[l] (width[l-1] + 1)
  for (int q = 1; q <= a.layers; ++q) {
    total += (size_t)a.width[q] * (a.width[q - 1] + 1);
  }
  const WgradEpi epi{a.part_w + (size_t)blockIdx.y * total + off,
                     x0 + 64 * wg, K, N};
  const bool active = x0 + 64 * wg <= K;   // this warpgroup has inputs
  const unsigned lb_s = smem_addr(lb);
  float acc[32];
  for (int s = 0; s < kDepth; ++s) issue(s);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kDepth - 1>();
    __syncthreads();
    prepare(s);
    __syncthreads();
    if (active) {
      stage_products<W>(ColA{hs + (s % kDepth) * kWS * kHLd, 64 * wg}, 0,
                        kWS / 16, lb_s + (unsigned)((s & 1) * 3 * kWLimb),
                        kWLimb, kWS / 8 * 128, s == 0, s == stages - 1, acc,
                        y0, epi);
    }
    __syncthreads();
    issue(s + kDepth);
  }
  cp_async_wait<0>();
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

#define DENSE_WIDTHS(X) X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64)

// The >48 KB opt-ins of every kernel and the row kernels' resident blocks,
// once a card (before any capture).
int prepare(int dev, int* resident) {
  static int blocks[kMaxDevices] = {};
  if (blocks[dev] == 0) {
    cudaError_t err = cudaSuccess;
    auto opt_in = [&](const void* f, size_t bytes) {
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      }
    };
#define DENSE_OPT_IN(W)                                                  \
  opt_in((const void*)dense_forward_kernel<W>, kSmemRows);               \
  opt_in((const void*)dense_backward_kernel<W>, kSmemRows);              \
  opt_in((const void*)dense_wgrad_kernel<W>, kSmemWgrad);
    DENSE_WIDTHS(DENSE_OPT_IN)
#undef DENSE_OPT_IN
    opt_in((const void*)dense_forward_kernel_head, kSmemHead);
    opt_in((const void*)dense_backward_kernel_head, kSmemHeadBackward);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dense_forward_kernel<kChunk>, kThreads, kSmemRows);
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

// A layer's n8 output columns as launches of one width each: equal chunks
// where a width from 64 down to 32 divides n8 (200 = 5 x 40), else chunks
// of 64 from column 0 and then the rest.  Returns the number of launches.
int column_ranges(int n8, int (&cb)[2], int (&nch)[2], int (&w)[2]) {
  for (int c = kChunk; c >= 32; c -= 8) {
    if (n8 % c == 0) {
      cb[0] = 0;
      nch[0] = n8 / c;
      w[0] = c;
      return 1;
    }
  }
  int k = 0;
  if (n8 >= kChunk) {
    cb[k] = 0;
    nch[k] = n8 / kChunk;
    w[k++] = kChunk;
  }
  cb[k] = n8 / kChunk * kChunk;
  nch[k] = 1;
  w[k++] = n8 % kChunk;
  return k;
}

// One row-kernel launch (kind 0 forward, 1 backward) of width w.
void launch_rows(int kind, int w, const Net& a, int l, int cb, int nch,
                 int grid, cudaStream_t st) {
  switch (w) {
#define DENSE_ROWS(W)                                                        \
  case W:                                                                    \
    if (kind == 0) {                                                         \
      dense_forward_kernel<W><<<grid, kThreads, kSmemRows, st>>>(a, l, cb,    \
                                                                 nch);       \
    } else {                                                                 \
      dense_backward_kernel<W><<<grid, kThreads, kSmemRows, st>>>(a, l, cb,   \
                                                                  nch);      \
    }                                                                        \
    break;
    DENSE_WIDTHS(DENSE_ROWS)
#undef DENSE_ROWS
    default:
      break;
  }
}

void launch_wgrad(int w, const Net& a, int l, int cb, size_t off, dim3 grid,
                  cudaStream_t st) {
  switch (w) {
#define DENSE_WGRAD(W)                                                     \
  case W:                                                                  \
    dense_wgrad_kernel<W><<<grid, kThreads, kSmemWgrad, st>>>(a, l, cb,    \
                                                              off);        \
    break;
    DENSE_WIDTHS(DENSE_WGRAD)
#undef DENSE_WGRAD
    default:
      break;
  }
}

// The network of the C arguments, checked; 0 or a CUDA error code.
int make_net(Net& a, int layers, const int* widths, const int* lds,
             const void* const* w, const void* const* b, const void* wh,
             const void* bh, int heads, int outcome, const float* reward,
             const void* h1, void* const* act, void* const* dpre,
             const void* elem, const void* count, int capacity, float sign) {
  if (layers < 1 || layers > kMaxLayers || heads < 1 || heads > kMaxHeads ||
      capacity < 0 || (outcome && heads < 2) || act == nullptr) {
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
    a.act[l] = (float*)act[l];
  }
  for (int l = 0; l <= layers && dpre; ++l) a.dpre[l] = (float*)dpre[l];
  a.wh = (const float*)wh;
  a.bh = (const float*)bh;
  a.h1 = (const float*)h1;
  a.elem = (const int*)elem;
  a.count = (const int*)count;
  return 0;
}

// The limbs' layout (transposed: W^T's, for the backward) and a launch of
// the split that fills them.  limbs holds sum_l 3 rows8 cols16 bf16
// (ops/dense.py::limb_entries).
int split_weights(Net& a, void* limbs, bool transposed, cudaStream_t st) {
  a.limbs = (unsigned char*)limbs;
  size_t off = 0;
  int pairs = 0;
  for (int l = 0; l < a.layers; ++l) {
    const int n = transposed ? a.width[l] : a.width[l + 1];
    const int k = transposed ? a.width[l + 1] : a.width[l];
    a.rows8[l] = round8(n);
    a.cols16[l] = (k + 15) & ~15;
    a.loff[l] = off;
    off += 3 * limb_bytes(a, l);
    pairs += a.rows8[l] * a.cols16[l] / 2;
  }
  const int grid = (pairs + 255) / 256;
  if (transposed) {
    dense_forward_kernel_split_weights<true><<<grid, 256, 0, st>>>(a, pairs);
  } else {
    dense_forward_kernel_split_weights<false><<<grid, 256, 0, st>>>(a, pairs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The forward: out (rows m) float32 gets sign y at each kept board's element
// (its floors are csrc/afterstate.cu's); act: L pointers to (capacity,
// lds[l + 1]) buffers that get every layer's activations (the backward's
// saved ones).  widths and lds: L + 1 ints (fc1's first), lds multiples of
// 4; w, b: L pointers; reward: heads floats on the host (outcome), or null;
// limbs: scratch for the weights' limbs (ops/dense.py::limb_entries).
extern "C" int dense_forward_launch(int layers, const int* widths,
                                    const int* lds, const void* const* w,
                                    const void* const* b, const void* wh,
                                    const void* bh, int heads, int outcome,
                                    const float* reward, const void* h1,
                                    void* const* act, const void* elem,
                                    const void* count, void* out, void* limbs,
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
  const auto st = (cudaStream_t)stream;
  const int tiles = (capacity + kRows - 1) / kRows;
  const int grid = std::min(tiles, resident);
  if (grid > 0) {
    err = split_weights(a, limbs, false, st);
    if (err != 0) return err;
    for (int l = 0; l < layers; ++l) {
      int cb[2], nch[2], w[2];
      const int n = column_ranges(a.rows8[l], cb, nch, w);
      for (int r = 0; r < n; ++r) {
        launch_rows(0, w[r], a, l, cb[r], nch[r], grid, st);
      }
    }
    dense_forward_kernel_head<<<grid, kThreads, kSmemHead, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The backward: grad (rows m) float32, the output's gradient; act the
// forward's saved activations; dpre L + 1 pointers to (capacity, lds[l])
// buffers that get every layer's dpre (dpre[0]: fc1's); part_rows holds
// row_blocks heads (widths[L] + 1) floats, part_w slices x sum widths[l]
// (widths[l-1] + 1); dflat gets the gradients in parameter order (W_1, b_1,
// ..., W_L, b_L, W_head, b_head); limbs: scratch for the transposed weights'
// limbs.  row_blocks and slices are numbers of the shapes (ops/dense.py).
extern "C" int dense_backward_launch(
    int layers, const int* widths, const int* lds, const void* const* w,
    const void* const* b, const void* wh, const void* bh, int heads,
    int outcome, const float* reward, const void* h1, void* const* act,
    void* const* dpre, const void* elem, const void* count, const void* grad,
    void* part_rows, int row_blocks, void* part_w, int slices, void* dflat,
    void* limbs, int capacity, float sign, void* stream) {
  Net a;
  int err = make_net(a, layers, widths, lds, w, b, wh, bh, heads, outcome,
                     reward, h1, act, dpre, elem, count, capacity, sign);
  if (err != 0) return err;
  if (row_blocks < 0 || slices < 1 || dpre == nullptr) {
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
    err = split_weights(a, limbs, true, st);
    if (err != 0) return err;
    dense_backward_kernel_head<<<row_blocks, kThreads, kSmemHeadBackward,
                                 st>>>(a);
    const int tiles = (capacity + kRows - 1) / kRows;
    const int grid = std::min(tiles, resident);
    for (int l = layers; l >= 1; --l) {
      int cb[2], nch[2], w[2];
      const int n = column_ranges(a.rows8[l - 1], cb, nch, w);
      for (int r = 0; r < n; ++r) {
        launch_rows(1, w[r], a, l, cb[r], nch[r], grid, st);
      }
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int entries = 0;
  size_t off = 0;
  for (int l = 1; l <= layers; ++l) {
    const int K = widths[l - 1] + 1, N = widths[l];
    int cb[2], nch[2], w[2];
    const int n = column_ranges(round8(N), cb, nch, w);
    for (int r = 0; r < n; ++r) {
      const dim3 grid(((K + kXT - 1) / kXT) * nch[r], slices);
      launch_wgrad(w[r], a, l, cb[r], off, grid, st);
    }
    entries += K * N;
    off += (size_t)K * N;
  }
  entries += heads * (widths[layers] + 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dense_reduce_kernel<<<(entries + 255) / 256, 256, 0, st>>>(a, row_blocks,
                                                            entries);
  return (int)cudaGetLastError();
}
