// Flash attention, forward and backward, hand-written for Hopper (sm_90a):
// the forward and the dQ kernel multiply with wgmma (warpgroup, bf16 in,
// float32 accumulators in registers), the dK/dV kernel with mma.sync
// m16n8k16 and ldmatrix; K/V (forward, dQ), Q/dO (dK/dV) and dS/K (dQ at
// DP 768) tiles are copied by cp.async into a two-stage ring while the
// previous tile is multiplied.
//
// Replaces the TPU kernel K4 of advise_tpu/ops/flash_attention.py flash_mha:
// JAX's library Pallas TPU flash attention and its custom-VJP backward
// (dq, dk, dv), which MultiScaleAttention calls under TPU.FLASH_ATTENTION.
//
// What it computes, per (batch*head) slice:
//   O   = softmax(Q K^T * scale) V            Q [nq, d], K and V [nk, d]
//   lse = log2(sum_j exp2(S_ij * scale * log2 e))   per query row (base 2)
//   D   = rowsum(dO o O)
//   P   = exp2(S * scale * log2 e - lse),  dS = P o (dO V^T - D)
//   dQ  = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
// bf16 in and out, float32 accumulation and float32 lse and D. The TPU
// wrapper pads nq and nk to 128 (masking the padded keys with SegmentIds)
// and d to a 128 multiple above 128; none of that is carried over: these
// kernels mask the ragged nq and nk edges themselves (copies past an edge
// are zero-filled, scores of keys >= nk are -inf exactly) and take d as it
// is, zero-padding it inside shared memory to the template width DP, the
// least of 64, 80, 144, 192, 288, 576, 768 that holds it (exact: zero
// columns add nothing to Q K^T and are not stored).
//
// Bound on the card: 4 nq nk d FLOP forward and 10 nq nk d backward per
// slice, against reading Q, K, V (and O, dO) once. At MViT-L 32x312's shapes
// (nq 1,600-97,344, nk 1,600-6,400, d 72-576) that is 200-1,000+ FLOP per
// byte: tensor-core bound; so is ContrastiveModel over MViT-S's d 768 at nq
// 1,568, nk 392 (~300), while its nq 392 is bound by its bytes.
//
// Design:
//  - every product's float32 result stays in its accumulator registers; a
//    warp holds 16 of its rows in the m16n8 layout (a wgmma's 64 rows are
//    its warpgroup's four warps'). The forward's online softmax (row max,
//    exp2, row sum, rescale of O) and the backward's P and dS run there with
//    quad shuffles, and P (dS) becomes the A operand of the next product in
//    registers, as that layout is the A layout of the next k-step. No
//    float32 tile goes through shared memory;
//  - forward and dQ: one block of two warpgroups per (query tile, slice)
//    loops over BK-key tiles. S = Q K^T (and dP = dO V^T) by wgmma from
//    shared memory; P V (dS K) by wgmma with P (dS) from the registers, in
//    chunks of at most 256 columns. Their tiles sit in 32-column atoms of
//    64-byte rows with the 64-byte swizzle (sw64), which the descriptors
//    name. Each warpgroup takes 64 query rows and all of d; at DP 576, where
//    a 64 x 576 float32 O would not fit the registers, both take the same 64
//    rows and half of d each, and each computes the rows' scores itself (the
//    same instructions on the same data, so the same P);
//  - DP 768 (DSPLIT 3): three warpgroups (384 threads) share 64 query rows,
//    each holding 256 columns of O (128 accumulator registers a thread; at
//    two warpgroups 384 columns would take 192 of the 168 a thread may hold
//    at 384 threads). Recomputing S in each would triple Q K^T, so each
//    contracts its own 256 columns of d and the three partial S tiles are
//    summed through shared memory, in warpgroup order, before the softmax:
//    every warpgroup sums the same floats in the same order, so all get the
//    same P. One such block fills an SM (210 KB, 168 registers a thread), so
//    the query tiles past the last full wave of 132 blocks run as key
//    ranges, a block each, whose float32 partials (O unnormalized, row max
//    and sum) a combine kernel sums in range order: the last wave is not a
//    whole key loop long. The dQ kernel cannot hold Q and dO (196 KB) beside
//    a K/V ring: there the dK/dV kernel writes dS (bf16, as the dQ product
//    takes it) to scratch and dQ = scale * dS K is a wgmma GEMM (dS tiles
//    K-major, K tiles N-major from shared memory, three warpgroups of 256
//    columns);
//    the dK/dV kernel keeps 16 keys a block (dK, dV: 96 accumulator columns
//    a warp) and, since 16 keys x 16 queries give four S^T and dP^T n-tiles
//    for eight warps, each warp contracts one n-tile over half of d and the
//    halves are summed through shared memory;
//  - dK/dV: one block of 8 warps per (BKV keys, slice, split), each split
//    walking a contiguous range of the query tiles. Its warps own 16 keys and
//    a 1/WC share of the query columns for S^T and dP^T, write P^T and dS^T
//    to shared memory as bf16, and then own 16 keys and a 1/WC share of d
//    for dV += P^T dO and dK += dS^T Q (ldmatrix, .trans for the row-major
//    B, from tiles whose row pitch DP + 8 bf16 puts each 8x8 matrix's rows on
//    distinct banks). With one split it writes dK and dV; with more it
//    writes float32 partials to scratch, which a reduce kernel sums in split
//    order, so a grid of few key tiles still fills the card. A preprocess
//    kernel computes D. Each output element (and each dS element at DP 768)
//    is written by one thread of one block and sums in a fixed order: no
//    atomics, so the backward is deterministic;
//  - copies: cp.async, 16 bytes a thread, zero-filled past the tensor's
//    edge; a d that is not a multiple of 8 takes plain loads (its rows are
//    not 16-byte aligned). Each loop tile goes into the ring's other stage
//    while the current one is multiplied.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. Each C entry point launches on the given stream and
// returns the first cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_WARPS = 8;
constexpr int COMBINE_MAX = 256;  // the forward's key ranges a split tile at most

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int pitch(int cols) { return cols + 8; }  // bf16 row pitch

// ---------------------------------------------------------------------------
// tile widths per padded head dim (ops/flash_attention.py TILES holds the same)
// ---------------------------------------------------------------------------
template <int DP> struct Tiles;
//   forward and dQ: BK keys a loop tile, DSPLIT warpgroups sharing 64 rows
//   (their columns split; DSPLIT 1: two warpgroups of 64 rows each; DSPLIT
//   3: S's contraction split too, dQ a GEMM on dS); dK/dV: BKV keys a block,
//   BQ queries a loop tile, WC warps per 16 keys (8 warps in all)
#define FLASH_TILES(DP_, FBK, FSPLIT, QBK, KROWS, KBQ, KWC)                      \
  template <> struct Tiles<DP_> {                                              \
    static constexpr int FWD_BK = FBK, SPLIT = FSPLIT, DQ_BK = QBK;            \
    static constexpr int KV_ROWS = KROWS, KV_BQ = KBQ, KV_WC = KWC;            \
  };
FLASH_TILES(64, 64, 1, 64, 128, 64, 1)
FLASH_TILES(80, 64, 1, 64, 128, 64, 1)
FLASH_TILES(144, 64, 1, 64, 64, 64, 2)
FLASH_TILES(192, 64, 1, 64, 64, 64, 2)
FLASH_TILES(288, 64, 1, 32, 64, 32, 2)
FLASH_TILES(576, 32, 2, 16, 32, 32, 4)
FLASH_TILES(768, 16, 3, 64, 16, 16, 8)
#undef FLASH_TILES

// the forward's and dQ's block: DSPLIT 1 two warpgroups of 64 rows each,
// else DSPLIT warpgroups (at least two) sharing 64 rows
__host__ __device__ constexpr int block_rows(int split) { return split == 1 ? 128 : 64; }
__host__ __device__ constexpr int block_threads(int split) { return 128 * (split < 2 ? 2 : split); }
// DSPLIT above 2: each warpgroup contracts a share of d for S, and dQ is
// the GEMM on dS
__host__ __device__ constexpr bool shared_s(int split) { return split > 2; }

// a warpgroup's columns in wgmma chunks of at most 256 (160 + 128 for 288)
template <int DP, int SPLIT>
struct Chunks {
  static constexpr int W = DP / SPLIT, N0 = W <= 256 ? W : 160, N1 = W - N0;
};

// the forward and dQ: 32-column atoms of 64-byte rows, and 1 KB to align
// them; with a shared S, the warpgroups' float32 partial S tiles; dQ's GEMM:
// a ring of dS tiles (64 rows x BK keys) and K tiles
size_t fwd_smem(int DP, int BK, int SPLIT) {
  return 1024 + 64 * (size_t)ceil_div(DP, 32) * (block_rows(SPLIT) + 4 * BK) +
         (shared_s(SPLIT) ? 4 * (size_t)SPLIT * 64 * BK : 0);
}
size_t dq_smem(int DP, int BK, int SPLIT) {
  if (shared_s(SPLIT))
    return 1024 + 2 * 64 * (size_t)(ceil_div(BK, 32) * 64 + ceil_div(DP, 32) * BK);
  return 1024 + 64 * (size_t)ceil_div(DP, 32) * (2 * block_rows(SPLIT) + 4 * BK);
}
// K, V, two stages of Q and dO, P^T and dS^T, lse and D; with fewer than 8
// query columns a warp, the warps' partial S^T and dP^T n-tiles
size_t dkdv_smem(int DP, int BKV, int BQ, int WC) {
  return 2 * (size_t)(2 * BKV + 4 * BQ) * pitch(DP) + 2 * 2 * (size_t)BKV * pitch(BQ) +
         2 * 2 * 4 * (size_t)BQ + (BQ / WC < 8 ? 4 * (size_t)MAX_WARPS * 32 * 4 : 0);
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; valid == false writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  cp_async16(smem_addr(dst), src, valid);
}
// shared memory by its 32-bit address
__device__ __forceinline__ void st_shared(uint32_t a, bf16 x) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(a), "h"(*reinterpret_cast<unsigned short*>(&x))
               : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t a, float4 x) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(x.x), "f"(x.y),
               "f"(x.z), "f"(x.w)
               : "memory");
}
__device__ __forceinline__ float4 ld_shared4(uint32_t a) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(a)
               : "memory");
  return x;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x in one MUFU instruction (ex2.approx: 2 ulp; 2^-inf = 0; results below
// 2^-126 flush to 0, which no sum here can tell from their value)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma (the forward and dQ). A warpgroup (4 warps) multiplies 64
// rows; its accumulator holds, per warp, 16 rows in the m16n8 layout below.
// Operands in shared memory sit in 32-column atoms of 64-byte rows, 16-byte
// chunk c of row r stored at chunk c ^ ((r >> 1) & 3) (the 64-byte swizzle):
// K-major (Q, K: a row's d values along the row) or N-major (V as the B of
// P V: a key's d values along the row). A descriptor gives the start, the
// stride between 32-column atoms (LBO, N-major only) and between 8-row
// groups (SBO, 512 B). The wrappers below, one per width the kernels use,
// name each accumulator register of the instruction.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)(512 >> 4) << 32 | (uint64_t)2 << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// makes this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk j of row r in a swizzled tile of `rows` rows
__device__ __forceinline__ int sw64(int r, int j, int rows) {
  return (j >> 2) * rows * 64 + r * 64 + (((j & 3) ^ ((r >> 1) & 3)) << 4);
}

// d (64 x 64) = (scale_d ? d : 0) + A B, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32) = (scale_d ? d : 0) + A B, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16) = (scale_d ? d : 0) + A B, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[2][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A B, A from registers, B from shared memory (N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 80) += A B, A from registers, B from shared memory (N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[10][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, 1, 1, 1, 1;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 128) += A B, A from registers, B from shared memory (N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 144) += A B, A from registers, B from shared memory (N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[18][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, 1, 1, 1, 1;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]),
        "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]),
        "+f"(d[17][2]), "+f"(d[17][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 160) += A B, A from registers, B from shared memory (N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[20][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, 1, 1, 1, 1;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]),
        "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]),
        "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]),
        "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 192) += A B, A from registers, B from shared memory (N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[24][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, 1, 1, 1, 1;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]),
        "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]),
        "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]),
        "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]),
        "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]),
        "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]),
        "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// the 128 accumulator operands of a 64 x 256 wgmma: d[i][0..3], i < 32
#define ACC4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define ACC128 \
  ACC4(0), ACC4(1), ACC4(2), ACC4(3), ACC4(4), ACC4(5), ACC4(6), ACC4(7), \
  ACC4(8), ACC4(9), ACC4(10), ACC4(11), ACC4(12), ACC4(13), ACC4(14), \
  ACC4(15), ACC4(16), ACC4(17), ACC4(18), ACC4(19), ACC4(20), ACC4(21), \
  ACC4(22), ACC4(23), ACC4(24), ACC4(25), ACC4(26), ACC4(27), ACC4(28), \
  ACC4(29), ACC4(30), ACC4(31)

// d (64 x 256) += A B, A from registers, B from shared memory (N-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : ACC128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 256) += A B, A from shared memory (K-major), B from shared memory
// (N-major)
__device__ __forceinline__ void wgmma_ss_n(float (&d)[32][4], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, 1;\n"
      : ACC128
      : "l"(da), "l"(db));
}
#undef ACC128
#undef ACC4

// ---------------------------------------------------------------------------
// fragments. A lane holds, of a 16 x 8 accumulator tile, rows lane / 4 (c0,
// c1) and lane / 4 + 8 (c2, c3) at columns 2 (lane % 4) + {0, 1}.
// ---------------------------------------------------------------------------

// A operand, rows m0..m0+15 and columns k0..k0+15 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base, int ld, int m0,
                                       int k0, int lane) {
  ldsm_x4(a, base + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// acc[n] += a B over NT n-tiles of 8 columns, where B (k x n) is stored
// transposed: rows n0 + 8 n + .. of a row-major [n][k] tile, columns k0..k0+15
template <int NT>
__device__ __forceinline__ void mma_bt(float (&acc)[NT][4], const uint32_t (&a)[4],
                                       const bf16* base, int ld, int n0, int k0, int lane) {
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    if (n + 1 < NT) {
      uint32_t b[4];
      ldsm_x4(b, base + (n0 + n * 8 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     (((lane >> 3) & 1) << 3));
      mma(acc[n], a, b[0], b[1]);
      mma(acc[n + 1], a, b[2], b[3]);
    } else {
      uint32_t b[2];
      ldsm_x2(b, base + (n0 + n * 8 + (lane & 7)) * ld + k0 + (((lane >> 3) & 1) << 3));
      mma(acc[n], a, b[0], b[1]);
    }
  }
}

// the same where B (k x n) is stored as is: rows k0..k0+15 of a row-major
// [k][n] tile, columns n0 + 8 n + ..
template <int NT>
__device__ __forceinline__ void mma_b(float (&acc)[NT][4], const uint32_t (&a)[4],
                                      const bf16* base, int ld, int k0, int n0, int lane) {
  const bf16* row = base + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0;
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    if (n + 1 < NT) {
      uint32_t b[4];
      ldsm_x4_t(b, row + n * 8 + ((lane >> 4) << 3));
      mma(acc[n], a, b[0], b[1]);
      mma(acc[n + 1], a, b[2], b[3]);
    } else {
      uint32_t b[2];
      ldsm_x2_t(b, row + n * 8);
      mma(acc[n], a, b[0], b[1]);
    }
  }
}

// the A operand of k-step j (columns 16 j..16 j+15) from an accumulator
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[NT][4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
}

// rows row0..row0+rows-1 of a row-major [n, d] bf16 matrix into a [rows, DP]
// tile of pitch pitch(DP): cp.async where rows are 16-byte aligned (the
// wrapper checks the base), plain loads otherwise; zeros past n and d
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int rows, int n, int d) {
  constexpr int LD = pitch(DP);
  const int nthreads = blockDim.x;
  if ((d & 7) == 0) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < rows * CH; i += nthreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      const bool valid = row0 + r < n && c < d;
      cp_async16(dst + r * LD + c, valid ? src + (size_t)(row0 + r) * d + c : src, valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += nthreads) {
      const int r = i / DP;
      const int c = i - r * DP;
      bf16 val = __float2bfloat16(0.0f);
      if (row0 + r < n && c < d) val = src[(size_t)(row0 + r) * d + c];
      dst[r * LD + c] = val;
    }
  }
}

// load_rows into the swizzled layout of the wgmma kernels, at shared address dst
template <int DP>
__device__ __forceinline__ void load_rows_sw(uint32_t dst, const bf16* __restrict__ src,
                                             int row0, int rows, int n, int d) {
  const int nthreads = blockDim.x;
  if ((d & 7) == 0) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < rows * CH; i += nthreads) {
      const int r = i / CH;
      const int j = i - r * CH;
      const bool valid = row0 + r < n && j * 8 < d;
      cp_async16(dst + sw64(r, j, rows), valid ? src + (size_t)(row0 + r) * d + j * 8 : src,
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += nthreads) {
      const int r = i / DP;
      const int c = i - r * DP;
      bf16 val = __float2bfloat16(0.0f);
      if (row0 + r < n && c < d) val = src[(size_t)(row0 + r) * d + c];
      st_shared(dst + sw64(r, c >> 3, rows) + (c & 7) * 2, val);
    }
  }
}
template <int DP>
__device__ __forceinline__ void load_rows_sw(unsigned char* dst, const bf16* __restrict__ src,
                                             int row0, int rows, int n, int d) {
  load_rows_sw<DP>(smem_addr(dst), src, row0, rows, n, d);
}

// columns c0..c0+COLS-1 of rows row0..row0+rows-1 of a row-major [n, ld]
// bf16 matrix (ld % 8 == 0, 16-byte aligned rows) into the swizzled layout;
// zeros past n and ld
template <int COLS>
__device__ __forceinline__ void load_cols_sw(unsigned char* dst, const bf16* __restrict__ src,
                                             int ld, int row0, int rows, int n, int c0) {
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH;
    const int j = i - r * CH;
    const bool valid = row0 + r < n && c0 + j * 8 < ld;
    cp_async16(dst + sw64(r, j, rows), valid ? src + (size_t)(row0 + r) * ld + c0 + j * 8 : src,
               valid);
  }
}

// two neighbouring outputs of row `row` (columns col, col + 1) of a [*, d] matrix
__device__ __forceinline__ void store2(bf16* out, size_t row, int col, int d, float x, float y) {
  bf16* p = out + row * d + col;
  if (col + 1 < d) {
    if ((d & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    } else {
      p[0] = __float2bfloat16(x);
      p[1] = __float2bfloat16(y);
    }
  } else if (col < d) {
    p[0] = __float2bfloat16(x);
  }
}
__device__ __forceinline__ void store2(float* out, size_t row, int col, int d, float x, float y) {
  float* p = out + row * d + col;
  if (col + 1 < d) {
    if ((d & 1) == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(x, y);
    } else {
      p[0] = x;
      p[1] = y;
    }
  } else if (col < d) {
    p[0] = x;
  }
}

// ---------------------------------------------------------------------------
// forward: one block of two warpgroups (DSPLIT 3: three) per (query tile,
// slice). S = Q K^T by wgmma from shared memory; P V by wgmma with P from
// the registers, in chunks N0 + N1 of a warpgroup's columns (a wgmma is at
// most 256 wide: 160 + 128 for 288 columns). With DSPLIT 1 the warpgroups
// take 64 query rows each and all of d; with DSPLIT 2 (d 576) both take the
// same 64 rows, each half of d, and each computes the rows' scores itself
// (the same instructions on the same data, so the same P); with DSPLIT 3 (d
// 768) the three take the same 64 rows and a third of d each, for O and for
// S's contraction, whose partial tiles they sum in shared memory
// ---------------------------------------------------------------------------
template <int DP, int BK, int DSPLIT, int N0, int N1>
__global__ void __launch_bounds__(block_threads(DSPLIT), 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ part, int nq, int nk, int d, float scale_log2, int whole,
                 int ksplit) {
  constexpr int AT = ceil_div(DP, 32);         // 32-column atoms
  constexpr int BQ = block_rows(DSPLIT);       // query rows of the block
  constexpr int NT = BK / 8;                   // key n-tiles of S
  constexpr bool SHARE = shared_s(DSPLIT);     // S contracted a share of d a warpgroup
  constexpr int KS = SHARE ? DP / DSPLIT / 16 : DP / 16;  // k-steps of S a warpgroup
  constexpr int T0 = N0 / 8, T1 = N1 > 0 ? N1 / 8 : 1;
  // a warpgroup's columns and its second chunk start on whole atoms
  static_assert((N1 == 0 || N0 % 32 == 0) && N0 <= 256 && N1 <= 256 &&
                    (N0 + N1) * DSPLIT == DP && (DSPLIT == 1 || (DP / DSPLIT) % 32 == 0),
                "chunks");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // shared addresses: Q, then K and V [2][AT][BK][64 B], then (SHARE)
  // [DSPLIT][128 threads][NT * 4] float partial S, a thread's accumulators
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + AT * BQ * 64;
  const uint32_t sV = sK + 2 * AT * BK * 64;
  const uint32_t sS = sV + 2 * AT * BK * 64;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;                      // this warp's warpgroup
  const int rows0 = DSPLIT == 1 ? 64 * wg : 0;  // its rows of the tile
  const int col0 = DSPLIT == 1 ? 0 : wg * (DP / DSPLIT);  // and its first column
  const int ks0 = SHARE ? wg * KS : 0;                   // its first k-step of S
  // the block's (slice, query tile) and its key tiles [kt0, kt1): SHARE
  // numbers the tiles slice-major on a 1-D grid, the first `whole` over
  // all keys, each later one over `ksplit` blocks, a key range each, whose
  // partial O, row max and row sum go to part[pi] for the combine kernel.
  // bh, q0 and pi wait out the loop in shared memory, so that no register
  // holds them beside O
  __shared__ int work[3];
  int bh = blockIdx.y, q0 = blockIdx.x * BQ, kt0 = 0, kt1 = ceil_div(nk, BK), pi = -1;
  if constexpr (SHARE) {
    int t = blockIdx.x;
    if (t >= whole) {
      pi = t - whole;
      t = whole + pi / ksplit;
      const int z = pi % ksplit, n = kt1;
      kt0 = z * n / ksplit;
      kt1 = (z + 1) * n / ksplit;
    }
    const int tq = ceil_div(nq, BQ);
    bh = t / tq;
    q0 = (t % tq) * BQ;
  }
  if (threadIdx.x == 0) {  // read after the loop's barriers
    work[0] = bh;
    work[1] = q0;
    work[2] = pi;
  }
  const bf16* kb = k + (size_t)bh * nk * d;
  const bf16* vb = v + (size_t)bh * nk * d;

  // tile j goes into stage j & 1
  load_rows_sw<DP>(sQ, q + (size_t)bh * nq * d, q0, BQ, nq, d);
  load_rows_sw<DP>(sK + (kt0 & 1) * AT * BK * 64, kb, kt0 * BK, BK, nk, d);
  load_rows_sw<DP>(sV + (kt0 & 1) * AT * BK * 64, vb, kt0 * BK, BK, nk, d);
  cp_async_commit();

  // the same for the whole warpgroup (SHARE: the block, whose rows start below nq)
  const bool active = SHARE || q0 + rows0 < nq;
  const uint32_t qa = sQ + rows0 * 64;
  float acc0[T0][4], acc1[T1][4];
  zero(acc0);
  zero(acc1);
  // running max and sum of rows lane/4 and lane/4 + 8 of this warp's 16
  float m[2] = {-3.402823466e38f, -3.402823466e38f}, l[2] = {0.0f, 0.0f};
  for (int j = kt0; j < kt1; ++j) {
    const int st = j & 1;
    if (j + 1 < kt1) {
      load_rows_sw<DP>(sK + (st ^ 1) * AT * BK * 64, kb, (j + 1) * BK, BK, nk, d);
      load_rows_sw<DP>(sV + (st ^ 1) * AT * BK * 64, vb, (j + 1) * BK, BK, nk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    if (active) {
      const uint32_t ka = sK + st * AT * BK * 64;
      const uint32_t va = sV + st * AT * BK * 64;
      float s[NT][4];
      if constexpr (SHARE) {
        // this warpgroup's share of d of S = Q K^T into shared memory; then S
        // = the warpgroups' partial tiles, summed in their order
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          const int ks = ks0 + i;
          wgmma_ss(s, wgmma_desc(qa + (ks >> 1) * BQ * 64 + (ks & 1) * 32, 16),
                   wgmma_desc(ka + (ks >> 1) * BK * 64 + (ks & 1) * 32, 16), i > 0);
        }
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int n = 0; n < NT; ++n)
          st_shared(sS + (threadIdx.x * NT + n) * 16,
                    make_float4(s[n][0], s[n][1], s[n][2], s[n][3]));
        __syncthreads();  // the whole block is active: its warpgroups share the rows
        const int t = threadIdx.x % 128;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 p0 = ld_shared4(sS + (t * NT + n) * 16);
          s[n][0] = p0.x;
          s[n][1] = p0.y;
          s[n][2] = p0.z;
          s[n][3] = p0.w;
        }
#pragma unroll
        for (int w = 1; w < DSPLIT; ++w) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float4 pw = ld_shared4(sS + ((w * 128 + t) * NT + n) * 16);
            s[n][0] += pw.x;
            s[n][1] += pw.y;
            s[n][2] += pw.z;
            s[n][3] += pw.w;
          }
        }
      } else {
        zero(s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)  // S = Q K^T
          wgmma_ss(s, wgmma_desc(qa + (ks >> 1) * BQ * 64 + (ks & 1) * 32, 16),
                   wgmma_desc(ka + (ks >> 1) * BK * 64 + (ks & 1) * 32, 16), ks > 0);
        wgmma_commit();
        wgmma_wait();
      }
      const int k0 = j * BK;
      if (k0 + BK > nk) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + n * 8 + 2 * (lane & 3) + (e & 1) >= nk) s[n][e] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float alpha[2], neg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = ex2((m[i] - mx[i]) * scale_log2);
        m[i] = mx[i];
        l[i] *= alpha[i];
        neg[i] = -mx[i] * scale_log2;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[n][e], scale_log2, neg[e >> 1]));
          s[n][e] = p;
          l[e >> 1] += p;
        }
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int n = 0; n < T0; ++n) {
          acc0[n][0] *= alpha[0];
          acc0[n][1] *= alpha[0];
          acc0[n][2] *= alpha[1];
          acc0[n][3] *= alpha[1];
        }
        if constexpr (N1 > 0) {
#pragma unroll
          for (int n = 0; n < T1; ++n) {
            acc1[n][0] *= alpha[0];
            acc1[n][1] *= alpha[0];
            acc1[n][2] *= alpha[1];
            acc1[n][3] *= alpha[1];
          }
        }
      }
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(a[kk], s, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // O += P V
        const uint32_t vk = va + (col0 / 32) * BK * 64 + kk * 16 * 64;
        wgmma_rs(acc0, a[kk], wgmma_desc(vk, BK * 64));
        if constexpr (N1 > 0) wgmma_rs(acc1, a[kk], wgmma_desc(vk + (N0 / 32) * BK * 64, BK * 64));
      }
      wgmma_commit();
      wgmma_wait();
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  if (!active) return;
  bh = work[0];
  q0 = work[1];
  pi = work[2];
  if (SHARE && pi >= 0) {  // a key range of a split tile: O unnormalized, row max and sum
    float* pb = part + (size_t)pi * (64 * DP + 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * (warp % 4) + lane / 4 + 8 * i;
      const float sum = quad_sum(l[i]);
#pragma unroll
      for (int n = 0; n < T0; ++n)
        *reinterpret_cast<float2*>(pb + r * DP + col0 + n * 8 + 2 * (lane & 3)) =
            make_float2(acc0[n][2 * i], acc0[n][2 * i + 1]);
      if (col0 == 0 && (lane & 3) == 0) {
        pb[64 * DP + r] = m[i];
        pb[64 * DP + 64 + r] = sum;
      }
    }
    return;
  }
  bf16* ob = o + (size_t)bh * nq * d;
  const int r0 = q0 + rows0 + 16 * (warp % 4) + lane / 4;  // rows r0, r0 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const float sum = quad_sum(l[i]);
    if (row >= nq) continue;
    const float inv = 1.0f / sum;
#pragma unroll
    for (int n = 0; n < T0; ++n)
      store2(ob, row, col0 + n * 8 + 2 * (lane & 3), d, acc0[n][2 * i] * inv,
             acc0[n][2 * i + 1] * inv);
    if constexpr (N1 > 0) {
#pragma unroll
      for (int n = 0; n < T1; ++n)
        store2(ob, row, col0 + N0 + n * 8 + 2 * (lane & 3), d, acc1[n][2 * i] * inv,
               acc1[n][2 * i + 1] * inv);
    }
    if (col0 == 0 && (lane & 3) == 0)
      lse[(size_t)bh * nq + row] = m[i] * scale_log2 + log2f(sum);
  }
}

// the forward's split tiles (DSPLIT 3): from the ksplit partials of each,
// in split order, O = sum_z 2^((m_z - m) scale_log2) O_z / l with m the
// largest m_z and l = sum_z 2^((m_z - m) scale_log2) l_z, and lse; one
// block per (row, split tile)
template <int DP>
__global__ void __launch_bounds__(256)
flash_fwd_combine_kernel(const float* __restrict__ part, bf16* __restrict__ o,
                         float* __restrict__ lse, int nq, int d, float scale_log2, int whole,
                         int ksplit) {
  constexpr int P = 64 * DP + 128;  // floats of a partial
  __shared__ float w[COMBINE_MAX];  // the ranges' weights over l
  const int r = blockIdx.x, t = whole + blockIdx.y;
  const int tq = ceil_div(nq, 64);
  const int row = (t % tq) * 64 + r;
  if (row >= nq) return;
  const size_t out = (size_t)(t / tq) * nq + row;
  const float* pb = part + (size_t)blockIdx.y * ksplit * P;
  if (threadIdx.x == 0) {
    float mx = -3.402823466e38f, sum = 0.0f;
    for (int z = 0; z < ksplit; ++z) mx = fmaxf(mx, pb[z * P + 64 * DP + r]);
    for (int z = 0; z < ksplit; ++z) {
      w[z] = ex2((pb[z * P + 64 * DP + r] - mx) * scale_log2);
      sum += w[z] * pb[z * P + 64 * DP + 64 + r];
    }
    for (int z = 0; z < ksplit; ++z) w[z] /= sum;
    lse[out] = mx * scale_log2 + log2f(sum);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < ksplit; ++z) acc += w[z] * pb[z * P + r * DP + c];
    o[out * d + c] = __float2bfloat16(acc);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D = rowsum(dO o O), one warp a row
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_bwd_pre_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * MAX_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* orow = o + (size_t)row * d;
  const bf16* grow = dout + (size_t)row * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += __bfloat162float(orow[c]) * __bfloat162float(grow[c]);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// dK, dV: one block per (BKV keys, slice, split), walking the split's query
// tiles; 8 warps as (BKV / 16 key groups) x WC. Where a warp's share of the
// query columns is under one n-tile (DP 768: 16 keys, 16 queries), each
// warp takes one of the 2 x BQ / 8 n-tiles of S^T and dP^T over a 1/KS
// share of d, the shares summed in shared memory in share order; the block
// then also writes dS [bh, nq, nkp] in bf16 for the dQ GEMM
template <int DP, int BKV, int BQ, int WC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part_k,
                      float* __restrict__ part_v, bf16* __restrict__ ds, int nkp, int nq, int nk,
                      int d, float scale, float scale_log2) {
  constexpr int LD = pitch(DP), LP = pitch(BQ);
  constexpr int QW = BQ / WC;                // S^T, dP^T: query columns of a warp
  constexpr bool SHARE = QW < 8;             // n-tiles of S^T and dP^T shared out over d
  constexpr int QNT = SHARE ? 1 : QW / 8;
  constexpr int STILES = 2 * (BQ / 8);       // SHARE: S^T and dP^T n-tiles (16 keys)
  constexpr int KS = SHARE ? MAX_WARPS / STILES : 1;  // SHARE: shares of d
  constexpr int DW = DP / WC, DNT = DW / 8;  // dK, dV: columns of a warp
  static_assert((BKV / 16) * WC == MAX_WARPS, "8 warps a block");
  static_assert(SHARE ? BKV == 16 && MAX_WARPS % STILES == 0 && DP % (16 * KS) == 0
                      : QW % 8 == 0,
                "S^T and dP^T n-tiles");
  static_assert(DW % 8 == 0, "whole n-tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BKV * LD;
  bf16* sQ = sV + BKV * LD;         // [2][BQ][LD]
  bf16* sdO = sQ + 2 * BQ * LD;     // [2][BQ][LD]
  bf16* sPt = sdO + 2 * BQ * LD;    // [BKV][LP]
  bf16* sdSt = sPt + BKV * LP;      // [BKV][LP]
  float* sL = reinterpret_cast<float*>(sdSt + BKV * LP);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                // [2][BQ]
  float* sX = sD + 2 * BQ;  // SHARE: [8 warps][32 lanes][4] partial n-tiles

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / WC, cg = warp % WC;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * BKV;
  const int splits = gridDim.z, z = blockIdx.z;
  const int ntq = ceil_div(nq, BQ);
  const int t_begin = (int)((long long)z * ntq / splits);
  const int t_end = (int)((long long)(z + 1) * ntq / splits);
  const bf16* qb = q + bh * nq * d;
  const bf16* gb = dout + bh * nq * d;
  const float* lb = lse + bh * nq;
  const float* db = delta + bh * nq;

  auto load_q_tile = [&](int t, int st) {
    load_rows<DP>(sQ + st * BQ * LD, qb, t * BQ, BQ, nq, d);
    load_rows<DP>(sdO + st * BQ * LD, gb, t * BQ, BQ, nq, d);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const int row = t * BQ + i;
      sL[st * BQ + i] = row < nq ? lb[row] : 0.0f;
      sD[st * BQ + i] = row < nq ? db[row] : 0.0f;
    }
  };
  load_rows<DP>(sK, k + bh * nk * d, k0, BKV, nk, d);
  load_rows<DP>(sV, v + bh * nk * d, k0, BKV, nk, d);
  load_q_tile(t_begin, 0);
  cp_async_commit();

  const bool active = k0 + rg * 16 < nk;
  float dka[DNT][4], dva[DNT][4];
  zero(dka);
  zero(dva);
  const int kr0 = k0 + rg * 16 + lane / 4;  // this lane's keys: kr0, kr0 + 8
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_q_tile(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tQ = sQ + st * BQ * LD;
    const bf16* tdO = sdO + st * BQ * LD;
    const float* tL = sL + st * BQ;
    const float* tD = sD + st * BQ;
    if constexpr (SHARE) {  // the block is active (16 keys, all < nk + 16)
      // this warp's n-tile: S^T = K Q^T (tile < STILES / 2) or dP^T = V dO^T,
      // over columns part * DP / KS .. of d
      const int tile = warp % STILES, part = warp / STILES;
      const bool dprod = tile >= STILES / 2;
      const int n0 = (tile % (STILES / 2)) * 8;
      float x[1][4];
      zero(x);
#pragma unroll 4
      for (int kk = part * (DP / KS); kk < (part + 1) * (DP / KS); kk += 16) {
        uint32_t a[4];
        load_a(a, dprod ? sV : sK, LD, 0, kk, lane);
        mma_bt<1>(x, a, dprod ? tdO : tQ, LD, n0, kk, lane);
      }
      reinterpret_cast<float4*>(sX)[warp * 32 + lane] =
          make_float4(x[0][0], x[0][1], x[0][2], x[0][3]);
      __syncthreads();
      if (warp < STILES / 2) {  // P and dS of query n-tile `warp`
        float s[4], dp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = dp[e] = 0.0f;
#pragma unroll
        for (int h = 0; h < KS; ++h) {
          const float4 ps = reinterpret_cast<const float4*>(sX)[(h * STILES + warp) * 32 + lane];
          const float4 pd =
              reinterpret_cast<const float4*>(sX)[(h * STILES + STILES / 2 + warp) * 32 + lane];
          s[0] += ps.x, s[1] += ps.y, s[2] += ps.z, s[3] += ps.w;
          dp[0] += pd.x, dp[1] += pd.y, dp[2] += pd.z, dp[3] += pd.w;
        }
        const bool edge = t * BQ + BQ > nq || k0 + 16 > nk;
        const int c = warp * 8 + 2 * (lane & 3);  // query column in the tile
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = c + (e & 1);
          float p = ex2(fmaf(s[e], scale_log2, -tL[cc]));
          if (edge && (t * BQ + cc >= nq || kr0 + 8 * (e >> 1) >= nk)) p = 0.0f;
          s[e] = p;
          dp[e] = p * (dp[e] - tD[cc]);
          if (t * BQ + cc < nq)  // keys past nk (up to nkp) get the masked 0
            ds[(bh * nq + t * BQ + cc) * nkp + kr0 + 8 * (e >> 1)] = __float2bfloat16(dp[e]);
        }
        const int r = lane / 4;
        *reinterpret_cast<uint32_t*>(sPt + r * LP + c) = pack_bf16(s[0], s[1]);
        *reinterpret_cast<uint32_t*>(sPt + (r + 8) * LP + c) = pack_bf16(s[2], s[3]);
        *reinterpret_cast<uint32_t*>(sdSt + r * LP + c) = pack_bf16(dp[0], dp[1]);
        *reinterpret_cast<uint32_t*>(sdSt + (r + 8) * LP + c) = pack_bf16(dp[2], dp[3]);
      }
    } else if (active) {  // S^T = K Q^T and dP^T = V dO^T for 16 keys x QW queries
      float s[QNT][4], dp[QNT][4];
      zero(s);
      zero(dp);
#pragma unroll 2
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t a[4];
        load_a(a, sK, LD, rg * 16, kk, lane);
        mma_bt<QNT>(s, a, tQ, LD, cg * QW, kk, lane);
        load_a(a, sV, LD, rg * 16, kk, lane);
        mma_bt<QNT>(dp, a, tdO, LD, cg * QW, kk, lane);
      }
      const bool edge = t * BQ + BQ > nq || k0 + rg * 16 + 16 > nk;
#pragma unroll
      for (int n = 0; n < QNT; ++n) {
        const int c = cg * QW + n * 8 + 2 * (lane & 3);  // query column in the tile
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = c + (e & 1);
          float p = ex2(fmaf(s[n][e], scale_log2, -tL[cc]));
          if (edge && (t * BQ + cc >= nq || kr0 + 8 * (e >> 1) >= nk)) p = 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - tD[cc]);
        }
        const int r = rg * 16 + lane / 4;
        *reinterpret_cast<uint32_t*>(sPt + r * LP + c) = pack_bf16(s[n][0], s[n][1]);
        *reinterpret_cast<uint32_t*>(sPt + (r + 8) * LP + c) = pack_bf16(s[n][2], s[n][3]);
        *reinterpret_cast<uint32_t*>(sdSt + r * LP + c) = pack_bf16(dp[n][0], dp[n][1]);
        *reinterpret_cast<uint32_t*>(sdSt + (r + 8) * LP + c) = pack_bf16(dp[n][2], dp[n][3]);
      }
    }
    __syncthreads();
    if (active) {  // dV += P^T dO, dK += dS^T Q for 16 keys x DW columns
#pragma unroll 2
      for (int kk = 0; kk < BQ; kk += 16) {
        uint32_t a[4];
        load_a(a, sPt, LP, rg * 16, kk, lane);
        mma_b<DNT>(dva, a, tdO, LD, kk, cg * DW, lane);
        load_a(a, sdSt, LP, rg * 16, kk, lane);
        mma_b<DNT>(dka, a, tQ, LD, kk, cg * DW, lane);
      }
    }
    __syncthreads();  // this stage and sPt, sdSt are free
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    if (key >= nk) continue;
#pragma unroll
    for (int n = 0; n < DNT; ++n) {
      const int col = cg * DW + n * 8 + 2 * (lane & 3);
      if (splits == 1) {
        store2(dk, bh * nk + key, col, d, dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
        store2(dv, bh * nk + key, col, d, dva[n][2 * i], dva[n][2 * i + 1]);
      } else {
        const size_t row = ((size_t)z * gridDim.y + bh) * nk + key;
        store2(part_k, row, col, d, dka[n][2 * i], dka[n][2 * i + 1]);
        store2(part_v, row, col, d, dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
  }
}

// dK = scale * sum_z part_k[z], dV = sum_z part_v[z], summed in split order
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_bwd_reduce_kernel(const float* __restrict__ part_k, const float* __restrict__ part_v,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, size_t n, int splits,
                        float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int z = 0; z < splits; ++z) {
      a += part_k[z * n + i];
      b += part_v[z * n + i];
    }
    dk[i] = __float2bfloat16(a * scale);
    dv[i] = __float2bfloat16(b);
  }
}

// dQ: one block of two warpgroups per (query tile, slice), over the key
// tiles, rows and columns as the forward's: S = Q K^T and dP = dO V^T by
// wgmma from shared memory, dS on the registers, dQ += dS K by wgmma with dS
// from the registers
template <int DP, int BK, int DSPLIT, int N0, int N1>
__global__ void __launch_bounds__(block_threads(DSPLIT), 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int nq, int nk, int d, float scale,
                    float scale_log2) {
  constexpr int AT = ceil_div(DP, 32);
  constexpr int BQ = block_rows(DSPLIT);
  constexpr int NT = BK / 8;
  constexpr int T0 = N0 / 8, T1 = N1 > 0 ? N1 / 8 : 1;
  static_assert((N1 == 0 || N0 % 32 == 0) && N0 <= 256 && N1 <= 256 &&
                    (N0 + N1) * DSPLIT == DP && DSPLIT <= 2 &&
                    (DSPLIT == 1 || (DP / DSPLIT) % 32 == 0),
                "chunks");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sdO = sQ + AT * BQ * 64;
  unsigned char* sK = sdO + AT * BQ * 64;  // [2][AT][BK][64 B]
  unsigned char* sV = sK + 2 * AT * BK * 64;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int rows0 = DSPLIT == 1 ? 64 * wg : 0;
  const int col0 = DSPLIT == 1 ? 0 : wg * (DP / 2);
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* kb = k + bh * nk * d;
  const bf16* vb = v + bh * nk * d;

  load_rows_sw<DP>(sQ, q + bh * nq * d, q0, BQ, nq, d);
  load_rows_sw<DP>(sdO, dout + bh * nq * d, q0, BQ, nq, d);
  load_rows_sw<DP>(sK, kb, 0, BK, nk, d);
  load_rows_sw<DP>(sV, vb, 0, BK, nk, d);
  cp_async_commit();

  const bool active = q0 + rows0 < nq;
  const uint32_t qa = smem_addr(sQ) + rows0 * 64, ga = smem_addr(sdO) + rows0 * 64;
  const int r0 = q0 + rows0 + 16 * (warp % 4) + lane / 4;  // rows r0, r0 + 8
  float rl[2], rd[2];  // their lse and D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    rl[i] = row < nq ? lse[bh * nq + row] : 0.0f;
    rd[i] = row < nq ? delta[bh * nq + row] : 0.0f;
  }
  float acc0[T0][4], acc1[T1][4];
  zero(acc0);
  zero(acc1);
  const int ntiles = ceil_div(nk, BK);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_rows_sw<DP>(sK + (st ^ 1) * AT * BK * 64, kb, (j + 1) * BK, BK, nk, d);
      load_rows_sw<DP>(sV + (st ^ 1) * AT * BK * 64, vb, (j + 1) * BK, BK, nk, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    if (active) {
      const uint32_t ka = smem_addr(sK + st * AT * BK * 64);
      const uint32_t va = smem_addr(sV + st * AT * BK * 64);
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {  // S = Q K^T, dP = dO V^T
        const uint32_t off = (ks >> 1) * BQ * 64 + (ks & 1) * 32;
        const uint32_t koff = (ks >> 1) * BK * 64 + (ks & 1) * 32;
        wgmma_ss(s, wgmma_desc(qa + off, 16), wgmma_desc(ka + koff, 16), ks > 0);
        wgmma_ss(dp, wgmma_desc(ga + off, 16), wgmma_desc(va + koff, 16), ks > 0);
      }
      wgmma_commit();
      wgmma_wait();
      const int k0 = j * BK;
      const bool edge = k0 + BK > nk;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[n][e], scale_log2, -rl[e >> 1]));
          if (edge && k0 + n * 8 + 2 * (lane & 3) + (e & 1) >= nk) p = 0.0f;
          dp[n][e] = p * (dp[n][e] - rd[e >> 1]);  // dS
        }
      }
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(a[kk], dp, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // dQ += dS K
        const uint32_t kk_addr = ka + (col0 / 32) * BK * 64 + kk * 16 * 64;
        wgmma_rs(acc0, a[kk], wgmma_desc(kk_addr, BK * 64));
        if constexpr (N1 > 0)
          wgmma_rs(acc1, a[kk], wgmma_desc(kk_addr + (N0 / 32) * BK * 64, BK * 64));
      }
      wgmma_commit();
      wgmma_wait();
    }
    __syncthreads();
  }
  if (!active) return;
  bf16* dqb = dq + bh * nq * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= nq) continue;
#pragma unroll
    for (int n = 0; n < T0; ++n)
      store2(dqb, row, col0 + n * 8 + 2 * (lane & 3), d, acc0[n][2 * i] * scale,
             acc0[n][2 * i + 1] * scale);
    if constexpr (N1 > 0) {
#pragma unroll
      for (int n = 0; n < T1; ++n)
        store2(dqb, row, col0 + N0 + n * 8 + 2 * (lane & 3), d, acc1[n][2 * i] * scale,
               acc1[n][2 * i + 1] * scale);
    }
  }
}


// dQ at DSPLIT 3 (d 768): dQ = scale * dS K, dS [bh, nq, nkp] bf16 from the
// dK/dV kernel (zero at keys nk..nkp-1). One block of DSPLIT warpgroups per
// (64 query rows, slice), each 256 columns of dQ, over BK-key tiles: dS
// tiles K-major and K tiles N-major in the swizzled layout, in a two-stage
// ring, multiplied by wgmma from shared memory
template <int DP, int BK, int DSPLIT>
__global__ void __launch_bounds__(block_threads(DSPLIT), 1)
flash_bwd_dq_gemm_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ k,
                         bf16* __restrict__ dq, int nq, int nk, int nkp, int d, float scale) {
  constexpr int AT = ceil_div(DP, 32), KA = BK / 32;  // atoms of a K tile, of a dS tile
  constexpr int W = DP / DSPLIT, T0 = W / 8;
  static_assert(W == 256 && BK % 32 == 0, "a warpgroup's 256 columns, whole dS atoms");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // [2][KA][64][64 B]
  unsigned char* sA = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sB = sA + 2 * KA * 64 * 64;  // [2][AT][BK][64 B]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = (warp / 4) * W;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const bf16* ab = ds + bh * nq * nkp;
  const bf16* kb = k + bh * nk * d;
  auto load_tile = [&](int j, int st) {
    load_cols_sw<BK>(sA + st * KA * 64 * 64, ab, nkp, q0, 64, nq, j * BK);
    load_rows_sw<DP>(sB + st * AT * BK * 64, kb, j * BK, BK, nk, d);
  };
  load_tile(0, 0);
  cp_async_commit();
  float acc[T0][4];
  zero(acc);
  const int ntiles = ceil_div(nkp, BK);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_tile(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t aa = smem_addr(sA + st * KA * 64 * 64);
    const uint32_t ba = smem_addr(sB + st * AT * BK * 64) + (col0 / 32) * BK * 64;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n(acc, wgmma_desc(aa + (kk >> 1) * 64 * 64 + (kk & 1) * 32, 16),
                 wgmma_desc(ba + kk * 16 * 64, BK * 64));
    wgmma_commit();
    wgmma_wait();
    __syncthreads();  // this stage is free for the tile after next
  }
  bf16* dqb = dq + bh * nq * d;
  const int r0 = q0 + 16 * (warp % 4) + lane / 4;  // rows r0, r0 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= nq) continue;
#pragma unroll
    for (int n = 0; n < T0; ++n)
      store2(dqb, row, col0 + n * 8 + 2 * (lane & 3), d, acc[n][2 * i] * scale,
             acc[n][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int DP>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, float* part,
               int bh, int nq, int nk, int d, float scale_log2, int whole, int ksplit,
               cudaStream_t st) {
  typedef Tiles<DP> T;
  typedef Chunks<DP, T::SPLIT> C;
  const int bq = block_rows(T::SPLIT);
  const size_t bytes = fwd_smem(DP, T::FWD_BK, T::SPLIT);
  auto kernel = flash_fwd_kernel<DP, T::FWD_BK, T::SPLIT, C::N0, C::N1>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if constexpr (shared_s(T::SPLIT)) {  // a 1-D grid, the last tiles split over keys
    const int n = bh * ceil_div(nq, bq);
    if (whole < 0 || whole > n || ksplit < 1 || ksplit > ceil_div(nk, T::FWD_BK) ||
        ksplit > COMBINE_MAX || (whole < n && !part))
      return (int)cudaErrorInvalidValue;
    kernel<<<whole + (n - whole) * ksplit, block_threads(T::SPLIT), bytes, st>>>(
        q, k, v, o, lse, part, nq, nk, d, scale_log2, whole, ksplit);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || whole == n) return (int)err;
    flash_fwd_combine_kernel<DP><<<dim3(64, n - whole), 256, 0, st>>>(part, o, lse, nq, d,
                                                                       scale_log2, whole, ksplit);
  } else {
    kernel<<<dim3(ceil_div(nq, bq), bh), block_threads(T::SPLIT), bytes, st>>>(
        q, k, v, o, lse, nullptr, nq, nk, d, scale_log2, 0, 1);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
               const float* delta, bf16* dq, bf16* dk, bf16* dv, float* part_k, float* part_v,
               bf16* ds, int bh, int nq, int nk, int d, float scale, float scale_log2, int splits,
               cudaStream_t st) {
  typedef Tiles<DP> T;
  typedef Chunks<DP, T::SPLIT> C;
  // dQ as the GEMM on dS exactly where the dK/dV kernel writes dS
  constexpr bool GEMM = shared_s(T::SPLIT);
  static_assert(GEMM == (T::KV_BQ / T::KV_WC < 8), "dS is written where dQ is its GEMM");
  if (splits < 1 || splits > ceil_div(nq, T::KV_BQ) || (splits > 1 && (!part_k || !part_v)) ||
      (GEMM && !ds))
    return (int)cudaErrorInvalidValue;
  const int nkp = ceil_div(nk, T::KV_ROWS) * T::KV_ROWS;  // dS's row: the key tiles' keys
  const size_t kv_bytes = dkdv_smem(DP, T::KV_ROWS, T::KV_BQ, T::KV_WC);
  auto kv_kernel = flash_bwd_dkdv_kernel<DP, T::KV_ROWS, T::KV_BQ, T::KV_WC>;
  cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_bytes);
  kv_kernel<<<dim3(ceil_div(nk, T::KV_ROWS), bh, splits), MAX_WARPS * 32, kv_bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, part_k, part_v, ds, nkp, nq, nk, d, scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const size_t n = (size_t)bh * nk * d;
    const int blocks = (int)(n / 256 + 1 < 132 * 8 ? n / 256 + 1 : 132 * 8);
    flash_bwd_reduce_kernel<<<blocks, 256, 0, st>>>(part_k, part_v, dk, dv, n, splits, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int bq = block_rows(T::SPLIT);
  const size_t q_bytes = dq_smem(DP, T::DQ_BK, T::SPLIT);
  const dim3 grid(ceil_div(nq, bq), bh);
  if constexpr (GEMM) {
    auto q_kernel = flash_bwd_dq_gemm_kernel<DP, T::DQ_BK, T::SPLIT>;
    cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_bytes);
    q_kernel<<<grid, block_threads(T::SPLIT), q_bytes, st>>>(ds, k, dq, nq, nk, nkp, d, scale);
  } else {
    auto q_kernel = flash_bwd_dq_kernel<DP, T::DQ_BK, T::SPLIT, C::N0, C::N1>;
    cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_bytes);
    q_kernel<<<grid, block_threads(T::SPLIT), q_bytes, st>>>(q, k, v, dout, lse, delta, dq, nq, nk,
                                                             d, scale, scale_log2);
  }
  return (int)cudaGetLastError();
}

template <int DP>
void tiles_of(int* out) {
  typedef Tiles<DP> T;
  const int vals[6] = {T::FWD_BK, T::SPLIT, T::DQ_BK, T::KV_ROWS, T::KV_BQ, T::KV_WC};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
}

// call FN<DP>(args) for the template width dp; -1 if there is none
#define FLASH_BY_DP(dp, FN, ...)                 \
  switch (dp) {                                  \
    case 64: return FN<64>(__VA_ARGS__);         \
    case 80: return FN<80>(__VA_ARGS__);         \
    case 144: return FN<144>(__VA_ARGS__);       \
    case 192: return FN<192>(__VA_ARGS__);       \
    case 288: return FN<288>(__VA_ARGS__);       \
    case 576: return FN<576>(__VA_ARGS__);       \
    case 768: return FN<768>(__VA_ARGS__);       \
    default: return -1;                          \
  }

template <int DP>
int tiles_ret(int* out) {
  tiles_of<DP>(out);
  return 0;
}

// blocks of a kernel of `threads` threads and `bytes` of dynamic shared
// memory that one SM holds at once
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t bytes) {
  int n = 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes);
  return n;
}

// blocks of each kernel that one SM holds at once
template <int DP>
int occupancy(int* out) {
  typedef Tiles<DP> T;
  typedef Chunks<DP, T::SPLIT> C;
  out[0] = blocks_per_sm(flash_fwd_kernel<DP, T::FWD_BK, T::SPLIT, C::N0, C::N1>,
                         block_threads(T::SPLIT), fwd_smem(DP, T::FWD_BK, T::SPLIT));
  out[1] = blocks_per_sm(flash_bwd_dkdv_kernel<DP, T::KV_ROWS, T::KV_BQ, T::KV_WC>, MAX_WARPS * 32,
                         dkdv_smem(DP, T::KV_ROWS, T::KV_BQ, T::KV_WC));
  const size_t dq_bytes = dq_smem(DP, T::DQ_BK, T::SPLIT);
  if constexpr (shared_s(T::SPLIT))
    out[2] = blocks_per_sm(flash_bwd_dq_gemm_kernel<DP, T::DQ_BK, T::SPLIT>,
                           block_threads(T::SPLIT), dq_bytes);
  else
    out[2] = blocks_per_sm(flash_bwd_dq_kernel<DP, T::DQ_BK, T::SPLIT, C::N0, C::N1>,
                           block_threads(T::SPLIT), dq_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile widths compiled for template width dp: out[0..5] = forward BK,
// DSPLIT (forward and dQ), dQ BK, dK/dV keys a block, queries a loop tile
// and warps per 16 keys. Returns 0, or -1 for a width not compiled.
int flash_tiles(int dp, int* out) { FLASH_BY_DP(dp, tiles_ret, out) }

// Blocks an SM holds at once: out[0] forward, out[1] dK/dV, out[2] dQ, at
// template width dp. Returns the CUDA error, or -1 for a width not compiled.
int flash_occupancy(int dp, int* out) { FLASH_BY_DP(dp, occupancy, out) }

// q [bh, nq, d], k and v [bh, nk, d] bf16, contiguous, 16-byte aligned when
// d % 8 == 0 -> o [bh, nq, d] bf16, lse [bh, nq] float32 (base 2). dp is
// the template width (the least compiled width >= d); scale >= 0. At dp
// 768 the query tiles (64 rows, slice-major) from `whole` on each run as
// `ksplit` key ranges into part [(tiles - whole) * ksplit, 64 * 768 + 128]
// float32 scratch, then combine; elsewhere whole and ksplit are unused.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* part,
              int bh, int nq, int nk, int d, int dp, float scale, int whole, int ksplit,
              void* stream) {
  if (d > dp || !(scale >= 0.0f)) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  FLASH_BY_DP(dp, launch_fwd, (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
              (float*)lse, (float*)part, bh, nq, nk, d, scale_log2, whole, ksplit,
              (cudaStream_t)stream)
}

// The gradients of flash_fwd: from q, k, v, its o and lse and the output
// gradient dout (all as flash_fwd's) -> dq, dk, dv bf16 in q's, k's and v's
// shapes, through delta [bh, nq] float32 scratch, when splits > 1 part_k
// and part_v [splits, bh, nk, d] float32 scratch, and at dp 768 ds [bh, nq,
// nkp] bf16 scratch (nkp: nk rounded up to the dK/dV kernel's 16 keys);
// splits is the dK/dV kernel's query-range splits.
int flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* delta, void* dq, void* dk, void* dv, void* part_k,
              void* part_v, void* ds, int bh, int nq, int nk, int d, int dp, float scale,
              int splits, void* stream) {
  if (d > dp) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = bh * nq;
  flash_bwd_pre_kernel<<<ceil_div(rows, MAX_WARPS), MAX_WARPS * 32, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, rows, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FLASH_BY_DP(dp, launch_bwd, (const bf16*)q, (const bf16*)k, (const bf16*)v,
              (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dq, (bf16*)dk,
              (bf16*)dv, (float*)part_k, (float*)part_v, (bf16*)ds, bh, nq, nk, d, scale,
              scale_log2, splits, st)
}

}  // extern "C"
