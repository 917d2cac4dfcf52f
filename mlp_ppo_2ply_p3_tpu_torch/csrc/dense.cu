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
// A whole row (csrc/afterstate.cu: under the logits epilogue, a row with n
// <= 0 whose m boards are one board) is one kept row, its element marked
// ~(r m): the head writes sign y into each of the row's m slots, and the
// backward's head takes the row's m entries of grad summed in a fixed order
// (a warp a row: each lane its slots lane, lane + 32, ..., then a
// butterfly) as that row's cotangent.
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
//   rows a warpgroup.  In the row kernels A (the rows) comes from registers,
//   split as it is read, and B (the weights) as limbs in shared memory; in
//   the weight gradient both come as limbs in shared memory.  Each product
//   kernel takes one fragment width W (a template parameter: ptxas
//   serializes the wgmma of a kernel that mixes widths), so a layer's row
//   kernels run as one launch of equal chunks where a width of 32 to 64
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
//   dpre_l^T [h_{l-1}, 1], split into a fixed number of row slices, each
//   slice's partial into scratch.  Warp-specialized: a TMA warp brings
//   stages of 16 rows in as float32 onto mbarriers, a warpgroup splits both
//   operands into limbs in shared memory once a stage, and two consumer
//   warpgroups, each on a unit of 64 inputs (wgmma's M) x W outputs (up to
//   128: a layer's outputs in ceil(N / 128) equal tiles), only run the
//   products (both operands from shared memory) and add the fragments.  The
//   split of a stage serves 128 to 256 outputs and 64 to 128 inputs, and
//   the grid is a whole number of waves on 132 SMs for any layer (SLICES).
// - dense_reduce_kernel: every gradient entry, the partials summed in slice
//   (block) order.  No float sum uses an atomic and the tensor cores sum in a
//   fixed order, so the gradients are the same bits on every run and card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "whole_rows.cuh"

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
constexpr int kWSplit = 4;          // wgrad: the split's warps (a
                                    // warpgroup), then two consumer
                                    // warpgroups and a TMA warp
constexpr int kWThreads = 32 * kWSplit + 288;
constexpr int kWRows = 16;          // wgrad: kept rows a stage (a k-step)
constexpr int kWFloat = 4;          // wgrad: float32 stages in flight
constexpr int kWLimbs = 4;          // wgrad: limb stages in flight
constexpr int kWLimbBytes = 3 * kWRows * 2;    // wgrad: a column's limbs a
                                               // stage
constexpr int kWTile = 128;         // wgrad: outputs at most a unit
constexpr int kWBoxH = 68;          // wgrad: floats a staged [h] row (64 +
                                    // 4)
constexpr unsigned kFull = 0xffffffffu;

struct Net {
  int layers;                       // L >= 1
  int heads;                        // J
  int outcome;                      // 1: softmax(z) . reward
  int capacity;                     // rows of every buffer
  int slices;                       // wgrad row slices
  int m;                            // slots a row of out and grad
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
// The weight gradient's columns a stage for units of W outputs: at most 128
// inputs and W outputs, or 64 and 2 W (WgradUnits); the floats of a staged
// stage (16 rows of [h]'s boxes of 64 + 4 columns and dpre's of W + 4, 4 mod
// 8 floats a row, so a warp's reads of rows 2 p, p = 0..3, meet no bank
// conflict); its shared memory: the float32 and limb stages and the
// mbarriers.  At W = 128: 207,968 bytes.
__host__ __device__ constexpr int wgrad_cols(int W) {
  return 128 + W > 64 + 2 * W ? 128 + W : 64 + 2 * W;
}
__host__ __device__ constexpr int wgrad_stage_floats(int W) {
  return kWRows * (2 * kWBoxH + W + 4 > kWBoxH + 2 * (W + 4)
                       ? 2 * kWBoxH + W + 4
                       : kWBoxH + 2 * (W + 4));
}
constexpr size_t wgrad_smem(int W) {
  return 4ull * kWFloat * wgrad_stage_floats(W) +
         (size_t)kWLimbs * kWLimbBytes * wgrad_cols(W) +
         16ull * (kWFloat + kWLimbs);
}

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

// mbarriers (a phase completes when its arrivals, and the bytes it expects,
// are in) and the bulk copies that complete on them.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// An arrival that also expects `bytes` more of bulk copies this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Until the phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// A box of a 2-D tensor map at (column x, row y) into shared dst (128-byte
// aligned), counted on bar; zeros where it lies past the tensor.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}
template <int R>
__device__ __forceinline__ void fence_frag(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B^T for a warpgroup, both from shared memory: A 64 x 16 and B N x
// 16 bf16, K-major (descriptors da, db); d 64 x N float32, scale 0
// overwrites it.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<72>(float (&d)[36], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35"
      "}, %36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<88>(float (&d)[44], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43"
      "}, %44, %45, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<104>(float (&d)[52], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<112>(float (&d)[56], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<120>(float (&d)[60], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59"
      "}, %60, %61, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale));
}

// t = the six limb products of a k-step from shared memory, smallest first,
// t overwritten: A's limb i at as + i la, B's limb j at bs + j lb, each
// 256 bytes between its groups of 8 rows (the stage's 16 k).
template <int W>
__device__ __forceinline__ void six_products_ss(float (&t)[W / 2],
                                                unsigned as, unsigned la,
                                                unsigned bs, unsigned lb) {
  const uint64_t a0 = limb_desc(as, 256), b0 = limb_desc(bs, 256);
  const uint64_t a1 = limb_desc(as + la, 256), b1 = limb_desc(bs + lb, 256);
  const uint64_t a2 = limb_desc(as + 2 * la, 256);
  const uint64_t b2 = limb_desc(bs + 2 * lb, 256);
  wgmma_ss<W>(t, a2, b0, 0);
  wgmma_ss<W>(t, a1, b1, 1);
  wgmma_ss<W>(t, a0, b2, 1);
  wgmma_ss<W>(t, a1, b0, 1);
  wgmma_ss<W>(t, a0, b1, 1);
  wgmma_ss<W>(t, a0, b0, 1);
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

// The head and the epilogue: tiles of h_L, out[elem[g]] = sign y (a whole
// row's m slots).
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
      const bool writes = (tid & 3) == 0 && row < nrows;
      const int e = row < nrows ? a.elem[g0 + row] : 0;
      if (writes && e >= 0) a.out[e] = a.sign * y;
      write_whole_rows(a.out, a.m, ~e, writes && e < 0, a.sign * y);
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
      // the row's cotangent (a whole row's summed by the warp, from the
      // row's first lane), on its four lanes
      const int e = row < nrows ? a.elem[g0 + row] : 0;
      float g = row < nrows && e >= 0 ? __ldg(a.grad + e) : 0.0f;
      g = whole_row_grad(a.grad, a.m, ~e,
                         (tid & 3) == 0 && row < nrows && e < 0, g);
      g = __shfl_sync(kFull, g, (tid & 31) & ~3);
      const float dy = row < nrows ? a.sign * g : 0.0f;
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

// split_pair's words in fewer instructions (the same bits): each part's two
// halves taken back to float32 by a shift and a mask.
__device__ __forceinline__ void split_word(float x, float y, uint32_t& p0,
                                           uint32_t& p1, uint32_t& p2) {
  auto pack = [](float lo, float hi_) {
    uint32_t w;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(w) : "f"(hi_), "f"(lo));
    return w;
  };
  p0 = pack(x, y);
  x -= __uint_as_float(p0 << 16);
  y -= __uint_as_float(p0 & 0xffff0000u);
  p1 = pack(x, y);
  x -= __uint_as_float(p1 << 16);
  y -= __uint_as_float(p1 & 0xffff0000u);
  p2 = pack(x, y);
}

// One staged box's limbs, a warp's tasks i < NT (8 columns x 4 pairs of
// rows each, a task of the split's warps in turn; those from n on are not
// stored): its lane's column col + 4 kWSplit i of the layer and rows 2 p,
// 2 p + 1 (sb at that column, and rs floats on) as one word of each limb
// (wb[32 kWSplit i], a limb lw words apart): a warp's 32 words are distinct
// banks, and so are its reads (rows 4 mod 8 floats apart).  kMask: columns
// from lim on read 0 (1 at lim where bias, [h, 1]'s bias column), and rows
// past the slice 0.  Every load first and no branch, so a warp's tasks split
// side by side.
template <int NT, bool kMask>
__device__ __forceinline__ void split_box(const float* sb, int rs,
                                          uint32_t* wb, int lw, int n,
                                          int col, int lim, bool bias,
                                          bool live0, bool live1) {
  float v[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    v[i][0] = sb[4 * kWSplit * i];
    v[i][1] = sb[4 * kWSplit * i + rs];
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float v0 = v[i][0], v1 = v[i][1];
    if (kMask) {
      const int c = col + 4 * kWSplit * i;
      const bool ok = c < lim, one = bias && c == lim;
      v0 = ok && live0 ? v0 : one && live0 ? 1.0f : 0.0f;
      v1 = ok && live1 ? v1 : one && live1 ? 1.0f : 0.0f;
    }
    uint32_t q0, q1, q2;
    split_word(v0, v1, q0, q1, q2);
    if (i < n) {
      wb[32 * kWSplit * i] = q0;
      wb[32 * kWSplit * i + lw] = q1;
      wb[32 * kWSplit * i + 2 * lw] = q2;
    }
  }
}

// The weight gradient's units: a block's two consumer warpgroups each take
// 64 inputs (wgmma's M) x W outputs of one layer.  Input tiles go in pairs
// (128 inputs x W outputs a block); where their number is odd, the last
// tile's blocks take it with two output tiles (64 x 2 W), and where that
// number is odd too, one unit has a block to itself.  The block's inputs
// [x0, x0 + 64 ma), outputs [y0, y0 + W nb).
struct WgradUnits {
  int x0, y0, ma, nb;
  __host__ __device__ static int count(int K, int N, int W) {
    const int nx = K / 64 + 1, ny = (N + W - 1) / W;
    return nx / 2 * ny + nx % 2 * ((ny + 1) / 2);
  }
  __device__ WgradUnits(int K, int N, int W, int u) {
    const int nx = K / 64 + 1, ny = (N + W - 1) / W, pairs = nx / 2;
    if (u < pairs * ny) {
      x0 = 128 * (u % pairs);
      y0 = W * (u / pairs);
      ma = 2;
      nb = 1;
    } else {
      const int v = u - pairs * ny;
      x0 = 64 * (nx - 1);
      y0 = 2 * W * v;
      ma = 1;
      nb = min(2, ny - 2 * v);
    }
  }
};

// dW_l and db_l, (width[l], width[l-1] + 1) with the bias last, at off in
// each slice's slab: dpre_l^T [h_{l-1}, 1] over row slice blockIdx.y, rows
// [count s / S, count (s + 1) / S), for unit pair blockIdx.x (WgradUnits),
// in stages of 16 rows (a k-step).  Warp-specialized, with no block barrier
// in the loop:
// - the TMA warp brings each stage in as float32 boxes ([h]'s 64 + 4
//   columns a box by th, dpre's W + 4 by td), kWFloat stages in flight on
//   full_f, each once the split has freed its slot (empty_f);
// - warpgroup 0 (kWSplit warps) splits both operands into their limbs once
//   a stage, in the K-major core-matrix layout that wgmma reads (the rows
//   are K), kWLimbs stages in flight on full_l, and gives registers up to
// - warpgroups 1 and 2, each on its unit: the stage's six products from
//   shared memory into a fresh fragment, the stage freed (empty_l), the
//   fragment added to the unit's sums.
// What bounds it (H100, wildbg's first minibatch): shared memory's
// bandwidth, which the TMA's writes, the split's reads and writes and the
// products' operand reads share (about 130 KB a stage of a 128 x 128 block,
// 1,000 cycles at 128 bytes a cycle); twice the split's warps, the
// consumers' A from registers or the consumers in turns did not move it.
template <int W>
__global__ void __launch_bounds__(kWThreads, 1)
    dense_wgrad_kernel(Net a, int l, size_t off,
                       const __grid_constant__ CUtensorMap th,
                       const __grid_constant__ CUtensorMap td) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int SF = wgrad_stage_floats(W), COLS = wgrad_cols(W);
  constexpr int DB = W + 4;           // floats a staged dpre row
  float* staged = reinterpret_cast<float*>(smem);
  unsigned char* limbs = smem + 4 * kWFloat * SF;
  uint64_t* full_f =
      reinterpret_cast<uint64_t*>(limbs + kWLimbs * kWLimbBytes * COLS);
  uint64_t* empty_f = full_f + kWFloat;
  uint64_t* full_l = empty_f + kWFloat;
  uint64_t* empty_l = full_l + kWLimbs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.width[l - 1], N = a.width[l];
  const WgradUnits u(K, N, W, blockIdx.x);
  const int MA = 64 * u.ma, NB = W * u.nb;
  const long long count = *a.count;
  const int r0 = (int)(count * blockIdx.y / a.slices);
  const int r1 = (int)(count * (blockIdx.y + 1) / a.slices);
  const int stages = (r1 - r0 + kWRows - 1) / kWRows;
  if (tid == 0) {
    for (int i = 0; i < kWFloat; ++i) {
      mbar_init(full_f + i, 1);
      mbar_init(empty_f + i, kWSplit);
    }
    for (int i = 0; i < kWLimbs; ++i) {
      mbar_init(full_l + i, kWSplit);
      mbar_init(empty_l + i, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (warp == kWSplit + 8) {
    // the TMA warp: stage s into float32 slot s % kWFloat once the split
    // has read what it held, [h]'s boxes, then dpre's (the rows past the
    // slice, and the columns past K or N, are set in the split)
    for (int s = 0; s < stages; ++s) {
      float* st = staged + (s % kWFloat) * SF;
      uint64_t* bar = full_f + s % kWFloat;
      const int rr = r0 + kWRows * s;
      mbar_wait(empty_f + s % kWFloat, ((s / kWFloat) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar, 4 * kWRows * (u.ma * kWBoxH + u.nb * DB));
        for (int i = 0; i < u.ma; ++i) {
          tma_load(st + i * kWRows * kWBoxH, &th, u.x0 + 64 * i, rr, bar);
        }
        for (int j = 0; j < u.nb; ++j) {
          tma_load(st + (u.ma * kWBoxH + j * DB) * kWRows, &td,
                   u.y0 + W * j, rr, bar);
        }
      }
      __syncwarp();
    }
  } else if (warp < kWSplit) {
    // the split needs few registers: 48 a thread to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    // a warp's tasks in a dpre box (at most kBoxTasks); this thread's
    // column in a task (k0, and its word wk0 in a limb's group) and pair of
    // rows (p)
    constexpr int kBoxTasks = (W / 4 + kWSplit - 1) / kWSplit;
    const int pw = warp, ntask = (W / 4 - pw + kWSplit - 1) / kWSplit;
    const int k0 = 8 * (pw >> 1) + (lane & 7), p = 4 * (pw & 1) + (lane >> 3);
    const int wk0 = 64 * (pw >> 1) + 32 * (pw & 1) + 4 * (lane & 7) +
                    (lane >> 3);
    for (int s = 0; s < stages; ++s) {
      const bool full = r1 - r0 - kWRows * s >= kWRows;
      const int nr = min(kWRows, r1 - r0 - kWRows * s);
      const float* src = staged + (s % kWFloat) * SF;
      unsigned char* dst = limbs + (size_t)(s % kWLimbs) * kWLimbBytes * COLS;
      mbar_wait(full_f + s % kWFloat, (s / kWFloat) & 1);
      mbar_wait(empty_l + s % kWLimbs, ((s / kWLimbs) & 1) ^ 1);
      // box by box ([h]'s, then dpre's), masked only where a box reaches
      // past the layer's width or the slice's rows (split_box)
      const bool live0 = 2 * p < nr, live1 = 2 * p + 1 < nr;
      uint32_t* dw = reinterpret_cast<uint32_t*>(dst) + wk0;
      for (int b = 0; b < u.ma; ++b) {
        const float* sb = src + b * kWRows * kWBoxH + 2 * p * kWBoxH + k0;
        const int col = u.x0 + 64 * b + k0;
        if (full && u.x0 + 64 * (b + 1) <= K) {
          split_box<16 / kWSplit, false>(sb, kWBoxH, dw + 512 * b, MA * 8,
                                         16 / kWSplit, col, K, true, live0,
                                         live1);
        } else {
          split_box<16 / kWSplit, true>(sb, kWBoxH, dw + 512 * b, MA * 8,
                                        16 / kWSplit, col, K, true, live0,
                                        live1);
        }
      }
      for (int b = 0; b < u.nb; ++b) {
        const float* sb = src + (u.ma * kWBoxH + b * DB) * kWRows +
                          2 * p * DB + k0;
        const int col = u.y0 + W * b + k0;
        uint32_t* wb = dw + 24 * MA + 8 * W * b;
        if (full && u.y0 + W * (b + 1) <= N) {
          split_box<kBoxTasks, false>(sb, DB, wb, NB * 8, ntask, col, N,
                                      false, live0, live1);
        } else {
          split_box<kBoxTasks, true>(sb, DB, wb, NB * 8, ntask, col, N,
                                     false, live0, live1);
        }
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(full_l + s % kWLimbs);
        mbar_arrive(empty_f + s % kWFloat);   // the float32 slot is read
      }
    }
  } else {
    // the consumers' fragments take the registers the producer gave up
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
    const int c = (warp - kWSplit) >> 2;
    const bool active = c == 0 || u.ma == 2 || u.nb == 2;
    const int moff = u.ma == 2 ? 64 * c : 0, noff = u.nb == 2 ? W * c : 0;
    const unsigned la = MA * 32, lb = NB * 32;   // bytes of a limb
    const unsigned base = smem_addr(limbs);
    float acc[W / 2], t[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
    for (int s = 0; s < stages; ++s) {
      const unsigned st = base + (unsigned)((s % kWLimbs) * kWLimbBytes * COLS);
      mbar_wait(full_l + s % kWLimbs, (s / kWLimbs) & 1);
      if (active) {
        fence_frag(t);
        wgmma_fence();
        six_products_ss<W>(t, st + (moff / 8) * 256, la,
                           st + 3 * la + (noff / 8) * 256, lb);
        wgmma_commit();
        wgmma_wait<0>();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_l + s % kWLimbs);
      if (active) {
        fence_frag(t);
#pragma unroll
        for (int i = 0; i < W / 2; ++i) acc[i] += t[i];
      }
    }
    if (active) {
      size_t total = 0;   // a slice's slab: sum width[l] (width[l-1] + 1)
      for (int q = 1; q <= a.layers; ++q) {
        total += (size_t)a.width[q] * (a.width[q - 1] + 1);
      }
      float* part = a.part_w + (size_t)blockIdx.y * total + off;
      // acc[4 j + 2 h + e]: input frag_row(h), output 8 j + frag_col() + e
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = u.x0 + moff + frag_row(hh);
            const int y = u.y0 + noff + 8 * j + frag_col() + e;
            if (x <= K && y < N) {
              part[(size_t)y * (K + 1) + x] = acc[4 * j + 2 * hh + e];
            }
          }
        }
      }
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

#define DENSE_WIDTHS(X) X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64)
#define DENSE_WGRAD_WIDTHS(X) \
  X(16) X(32) X(48) X(64) X(72) X(80) X(88) X(96) X(104) X(112) X(120) X(128)

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
  opt_in((const void*)dense_backward_kernel<W>, kSmemRows);
    DENSE_WIDTHS(DENSE_OPT_IN)
#undef DENSE_OPT_IN
#define DENSE_OPT_IN(W) \
  opt_in((const void*)dense_wgrad_kernel<W>, wgrad_smem(W));
    DENSE_WGRAD_WIDTHS(DENSE_OPT_IN)
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

// A layer's units' output width for the weight gradient: its N outputs as
// ceil(N / 128) tiles of one width, the narrowest instantiated one that
// covers them (a multiple of 16 to 64, of 8 past it: 250 = 2 x 128 - 6,
// 200 = 2 x 104 - 8).
int wgrad_width(int N) {
  const int tiles = (N + kWTile - 1) / kWTile;
  const int w = (N + tiles - 1) / tiles;
  return w <= 64 ? (w + 15) & ~15 : round8(w);
}

void launch_wgrad(int w, const Net& a, int l, size_t off, dim3 grid,
                  const CUtensorMap& th, const CUtensorMap& td,
                  cudaStream_t st) {
  switch (w) {
#define DENSE_WGRAD(W)                                                     \
  case W:                                                                  \
    dense_wgrad_kernel<W><<<grid, kWThreads, wgrad_smem(W), st>>>(a, l, off, \
                                                                th, td);   \
    break;
    DENSE_WGRAD_WIDTHS(DENSE_WGRAD)
#undef DENSE_WGRAD
    default:
      break;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// CUDA's tensor-map encoder, cuTensorMapEncodeTiled, looked up once at run
// time (the library links against the runtime only, not libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &q) == cudaSuccess &&
                   q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, ld) float32 buffer as boxes of cols x kWRows for TMA, zeros past
// its edges; 0 or a CUDA error code.  No rows: no map (none is loaded).
int row_boxes(CUtensorMap* m, const float* base, int ld, int rows, int cols) {
  *m = CUtensorMap{};
  if (rows == 0) return 0;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)kWRows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)base, dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// The network of the C arguments, checked; 0 or a CUDA error code.
int make_net(Net& a, int layers, const int* widths, const int* lds,
             const void* const* w, const void* const* b, const void* wh,
             const void* bh, int heads, int outcome, const float* reward,
             const void* h1, void* const* act, void* const* dpre,
             const void* elem, const void* count, int capacity, int m,
             float sign) {
  if (layers < 1 || layers > kMaxLayers || heads < 1 || heads > kMaxHeads ||
      capacity < 0 || m < 0 || (outcome && heads < 2) || act == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  a = Net{};
  a.m = m;
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
// (each of a whole row's m slots, where elem holds ~(r m); its floors are
// csrc/afterstate.cu's); act: L pointers to (capacity,
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
                                    int capacity, int m, float sign,
                                    void* stream) {
  Net a;
  int err = make_net(a, layers, widths, lds, w, b, wh, bh, heads, outcome,
                     reward, h1, act, nullptr, elem, count, capacity, m,
                     sign);
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

// The backward: grad (rows m) float32, the output's gradient (a whole row's
// m entries summed, where elem holds ~(r m)); act the
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
    void* limbs, int capacity, int m, float sign, void* stream) {
  Net a;
  int err = make_net(a, layers, widths, lds, w, b, wh, bh, heads, outcome,
                     reward, h1, act, dpre, elem, count, capacity, m, sign);
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
    const int K = widths[l - 1] + 1, N = widths[l], w = wgrad_width(N);
    CUtensorMap th, td;
    err = row_boxes(&th, l >= 2 ? a.act[l - 2] : a.h1, a.ld[l - 1], capacity,
                    kWBoxH);
    if (err == 0) err = row_boxes(&td, a.dpre[l], a.ld[l], capacity, w + 4);
    if (err != 0) return err;
    launch_wgrad(w, a, l, off, dim3(WgradUnits::count(K - 1, N, w), slices),
                 th, td, st);
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
