// Flash attention, forward and backward, float32-accurate on Hopper's tensor
// cores (3xTF32): the K4 pair for the inputs the bf16 kernels of
// flash_attention.cu do not take, float32 q, k, v at any head dim and bf16
// above 768.
//
// Replaces, for those inputs, the TPU kernel K4 of
// advise_tpu/ops/flash_attention.py flash_mha (JAX's library Pallas TPU
// flash attention and its custom-VJP backward), which takes float32 and pads
// any head dim; MultiScaleAttention calls it under TPU.FLASH_ATTENTION, so
// TPU.COMPUTE_DTYPE float32 reaches it.
//
// What it computes, per (batch*head) slice, as flash_attention.cu does:
//   O   = softmax(Q K^T * scale) V,  lse = log2(sum_j exp2(S_ij * scale * log2 e))
//   D   = rowsum(dO o O),  P = exp2(S * scale * log2 e - lse),  dS = P o (dO V^T - D)
//   dQ  = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
// Inputs of type T (float or bf16, converted to float on load), outputs
// written as T; lse and D float32.
//
// The arithmetic: 3xTF32. The tensor cores take float32 only as TF32 (10
// mantissa bits), so every float32 operand x is split into big =
// cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and a product a b is
// accumulated in float32 as a_small b_big + a_big b_small + a_big b_big (the
// small x small term, below 2^-22 of the product, is dropped): CUTLASS's
// OpMultiplyAddFastF32. cvt.rna rounds both halves to nearest (a raw float32
// register fed to a TF32 MMA would have its low 13 bits cut, not rounded).
// A bf16 input is exact in TF32, so its small half is zero: with bf16 q, k,
// v and dO the kernels skip the terms of those operands' small halves (S
// and dP take one MMA, P V, dS K, P^T dO and dS^T Q two). P and dS are float32
// in either case and always split.
//
// Bound on the card: 4 nq nk d FLOP forward and 10 nq nk d backward per
// slice, each float32 FLOP three TF32 tensor-core FLOP: at the dense TF32
// rate of 495 TFLOP/s, 3 * FLOP / 495e12 s, against reading Q, K, V (O, dO)
// once: operation-bound at every shape MViT-L runs.
//
// Design: the flash structure of flash_attention.cu for 4-byte operands,
// every product by mma.sync m16n8k8 TF32 (wgmma takes TF32 only with both
// operands K-major in shared memory and has no transpose for 32-bit types;
// P V, dS K, P^T dO and dS^T Q contract over the row axis of a [rows, d]
// tile, and mma.sync's per-thread B fragments read either orientation):
//  - a warp owns 16 rows (queries in the forward and dQ, keys in dK/dV) in
//    the m16n8 accumulator layout. Scores, P and dS stay in registers, as
//    do the output tiles O, dQ, dK and dV (CW columns a warp: 72, 144 or
//    288, 4 registers per 8 columns). An accumulator becomes the A operand
//    of the next product in place: a lane holds its columns 2t, 2t+1, which
//    serve as A's columns t, t+4 (acc_to_a), and the B operand's rows are
//    read in that order (load_b: rows 2t, 2t+1 of each 8), which costs
//    nothing;
//  - tiles sit in shared memory as float32 rows of pitch width + 4 floats,
//    so a warp's fragment loads (rows g, columns t, or rows 2t, columns g)
//    fall on 32 distinct banks;
//  - up to head dim 288 one operand stays resident (Q in the forward, Q and
//    dO in dQ, K and V in dK/dV) and the other side streams through a
//    two-stage cp.async ring, a tile loading while the previous one is
//    multiplied (the forward streams K and V as separate units, so S = Q K^T
//    overlaps V's copy and O += P V the next K's). Above 288 nothing of full
//    width stays: the contraction over d streams in chunks (144 columns; dQ 32) of both
//    operands, and grid z splits the output columns into parts of at most
//    288, each part recomputing the scores;
//  - the online softmax is base 2: one FFMA and one ex2 per score, the row
//    max and sum in registers (quad shuffles); keys past nk are -inf before
//    the row max;
//  - an output product (P V, dS K, P^T dO, dS^T Q) sums each tile's few
//    k-steps into a fresh accumulator and adds that to the running total
//    with one float32 FFMA (acc_product, fold). An MMA rounds its sum
//    toward zero, so chained into one accumulator over all of nq or nk the
//    error grows with the chain in one direction: dK at 97,344 queries
//    missed 1e-4 of its largest entry that way;
//  - backward: a pre-pass computes D; the dK/dV kernel walks a split's
//    query tiles (its blocks' query ranges split so the grid fills 132 SMs,
//    float32 partials summed in split order by a reduce kernel); at head
//    dims 145-288 two warps share 16 keys, each holding half of dK's and
//    dV's columns (both compute the keys' scores); the dQ kernel walks all
//    key tiles. Each output element is written by one thread after sums in
//    a fixed order: no atomics, so the backward is deterministic.
// make_plan below is the launch plan (ops/flash_attention.py f32_plan holds
// the same arithmetic; flash_f32_plan returns it for the card tests).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. Each C entry point launches on the given stream and
// returns the first cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PAD = 4;        // a tile row's pitch: its width + PAD floats
constexpr int RES_MAX = 288;  // widest head dim whose operand tiles stay resident
constexpr int STAGES = 2;     // the cp.async ring
constexpr int MAX_THREADS = 256;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return ceil_div(a, b) * b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// ---------------------------------------------------------------------------
// the launch plan
// ---------------------------------------------------------------------------
enum Kernel { FWD = 0, DQ = 1, DKDV = 2 };

// compiled widths per kernel and tier (head dim rounded to 8: <= 72, <= 144,
// above; bf16 inputs always take the last): CW accumulator columns a warp
// holds, BK keys a loop tile (dK/dV: queries), WARPS a block
constexpr int CW_OF[3][3] = {{72, 144, 288}, {72, 144, 288}, {72, 144, 144}};
constexpr int BK_OF[3][3] = {{64, 32, 32}, {32, 32, 16}, {32, 32, 16}};
constexpr int WARPS_OF[3][3] = {{8, 8, 8}, {8, 8, 4}, {8, 8, 8}};
// columns of a streamed chunk (head dims above RES_MAX) per kernel: dQ's
// small chunks let two of its 4-warp blocks share an SM
constexpr int DC_OF[3] = {144, 32, 144};

struct Plan {
  int cw;      // accumulator columns a warp holds
  int bk;      // forward, dQ: keys a loop tile; dK/dV: queries a loop tile
  int warps;   // warps a block
  int wc;      // dK/dV: warps sharing 16 keys, each 1/wc of the columns
  int rows;    // rows a block owns: queries (forward, dQ), keys (dK/dV)
  int stream;  // 1: the contraction over d streams in DC_OF-column chunks
  int kc;      // columns of a contraction chunk: d rounded to 8, or DC_OF
  int cols;    // output columns a block holds
  int parts;   // output column parts (grid z; dK/dV: times the splits)
  int smem;    // dynamic shared memory, bytes
};

inline int tier_of(int d, int bf16) {
  const int d8 = round_up(d, 8);
  return bf16 || d8 > 144 ? 2 : d8 > 72 ? 1 : 0;
}

inline Plan make_plan(int kernel, int d, int bf16) {
  const int tier = tier_of(d, bf16), d8 = round_up(d, 8);
  Plan p;
  p.cw = CW_OF[kernel][tier];
  p.bk = BK_OF[kernel][tier];
  p.warps = WARPS_OF[kernel][tier];
  p.stream = d8 > RES_MAX;
  p.parts = p.stream ? ceil_div(d, RES_MAX) : 1;
  p.cols = p.stream ? round_up(ceil_div(d, p.parts), 8) : d8;
  p.kc = p.stream ? DC_OF[kernel] : d8;
  p.wc = kernel == DKDV ? ceil_div(p.cols, p.cw) : 1;
  p.rows = 16 * p.warps / p.wc;
  const int pc = p.kc + PAD, po = p.cols + PAD;
  int res, slot;
  if (kernel == FWD) {  // Q resident; units: K (or chunks of Q and K), then V
    res = p.stream ? 0 : p.rows * pc;
    slot = imax((p.stream ? p.rows * pc : 0) + p.bk * pc, p.bk * po);
  } else if (kernel == DQ) {  // Q, dO resident; units: K and V (or chunks of Q, dO, K, V, then K)
    res = p.stream ? 0 : 2 * p.rows * pc;
    slot = p.stream ? imax(2 * (p.rows + p.bk) * pc, p.bk * po) : 2 * p.bk * pc;
  } else {  // K, V resident; units: Q and dO (or chunks of K, V, Q, dO, then Q and dO); lse, D
    res = p.stream ? 0 : 2 * p.rows * pc;
    slot = (p.stream ? imax(2 * (p.rows + p.bk) * pc, 2 * p.bk * po) : 2 * p.bk * pc) + 2 * p.bk;
  }
  p.smem = 4 * (res + STAGES * slot);
  return p;
}

// floats of a ring slot (the same arithmetic as make_plan)
__device__ __forceinline__ int slot_floats(int kernel, const Plan& p) {
  const int pc = p.kc + PAD, po = p.cols + PAD;
  if (kernel == FWD) return imax((p.stream ? p.rows * pc : 0) + p.bk * pc, p.bk * po);
  if (kernel == DQ) return p.stream ? imax(2 * (p.rows + p.bk) * pc, p.bk * po) : 2 * p.bk * pc;
  return (p.stream ? imax(2 * (p.rows + p.bk) * pc, 2 * p.bk * po) : 2 * p.bk * pc) + 2 * p.bk;
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared; valid == false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// 2^x in one MUFU instruction (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// c += a b, m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// fragments. g = lane / 4, t = lane % 4. A lane holds, of a 16 x 8
// accumulator, (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1); of an A operand (16
// x 8), (g, t) (g+8, t) (g, t+4) (g+8, t+4); of a B operand (8 x 8), (k t,
// n g) (k t+4, n g). Each operand value is held split: hi = big, lo = small
// (unset where the operand is EXACT, a bf16 value).
// ---------------------------------------------------------------------------
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  if (!EXACT) lo = tf32(x - __uint_as_float(hi));
}

// c += a b in 3xTF32: small x big, big x small, then big x big; the terms
// of an EXACT operand's small half (zero) are skipped
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  if constexpr (!AX) mma_tf32(c, a.lo, b.hi);
  if constexpr (!BX) mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// A = rows r0.., columns k0.. of a row-major tile of pitch p
template <bool EXACT>
__device__ __forceinline__ void load_a(FragA& f, const float* x, int p, int r0, int k0,
                                       int lane) {
  const float* b = x + (r0 + (lane >> 2)) * p + k0 + (lane & 3);
  split<EXACT>(b[0], f.hi[0], f.lo[0]);
  split<EXACT>(b[8 * p], f.hi[1], f.lo[1]);
  split<EXACT>(b[4], f.hi[2], f.lo[2]);
  split<EXACT>(b[8 * p + 4], f.hi[3], f.lo[3]);
}

// B[k][n] = y[n0 + n][k0 + k]: a row-major tile whose rows run along n (K in
// Q K^T, V in dO V^T, Q in K Q^T, dO in V dO^T)
template <bool EXACT>
__device__ __forceinline__ void load_bt(FragB& f, const float* y, int p, int n0, int k0,
                                        int lane) {
  const float* b = y + (n0 + (lane >> 2)) * p + k0 + (lane & 3);
  split<EXACT>(b[0], f.hi[0], f.lo[0]);
  split<EXACT>(b[4], f.hi[1], f.lo[1]);
}

// B[k][n] = y[k0 + r(k)][n0 + n] with r(t) = 2t, r(t + 4) = 2t + 1: a tile
// whose rows run along k (V in P V, K in dS K, dO in P^T dO, Q in dS^T Q),
// its rows in the order acc_to_a leaves an accumulator's columns
template <bool EXACT>
__device__ __forceinline__ void load_b(FragB& f, const float* y, int p, int k0, int n0,
                                       int lane) {
  const float* b = y + (k0 + 2 * (lane & 3)) * p + n0 + (lane >> 2);
  split<EXACT>(b[0], f.hi[0], f.lo[0]);
  split<EXACT>(b[p], f.hi[1], f.lo[1]);
}

// the A operand of an accumulator n-tile: its columns 2t, 2t + 1 serve as
// A's columns t, t + 4 (load_b reads B's rows in the same order)
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split<false>(c[0], f.hi[0], f.lo[0]);
  split<false>(c[2], f.hi[1], f.lo[1]);
  split<false>(c[1], f.hi[2], f.lo[2]);
  split<false>(c[3], f.hi[3], f.lo[3]);
}

// c = c * (a0, a1 by row) + t, rounded to nearest: the tensor cores round
// an MMA's sum toward zero, so a product chained over thousands of
// k-steps into one accumulator drifts by ~2^-24 a step in one direction.
// Each output product therefore runs its tile's few k-steps into a fresh
// accumulator t and is folded into the running total here.
__device__ __forceinline__ void fold(float (&c)[4], const float (&t)[4], float a0, float a1) {
  c[0] = fmaf(c[0], a0, t[0]);
  c[1] = fmaf(c[1], a0, t[1]);
  c[2] = fmaf(c[2], a1, t[2]);
  c[3] = fmaf(c[3], a1, t[3]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
}

// out[n] = out[n] * (a0, a1 by row) + sum_kk A_kk B_kk,n for the output
// n-tiles whose columns c0 + 8 n.. lie below cols (every one when FULL): A
// from accumulator tiles (acc_to_a), B from the rows of y (pitch p, load_b),
// each n-tile's sum in a fresh accumulator folded in by fold(). FULL
// compiles the loop without guards, so the n-tiles' MMA chains interleave.
template <bool FULL, bool X, int NK, int NO>
__device__ __forceinline__ void acc_product(float (&out)[NO][4], const FragA (&a)[NK],
                                            const float* y, int p, int c0, int cols, float a0,
                                            float a1, int lane) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (FULL || c0 + 8 * n < cols) {
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        FragB fb;
        load_b<X>(fb, y, p, 8 * kk, c0 + 8 * n, lane);
        mma3<false, X>(t, a[kk], fb);
      }
      fold(out[n], t, a0, a1);
    }
  }
}

// ---------------------------------------------------------------------------
// copies: rows [row0, row0 + rows) and columns [col0, col0 + width) of a
// row-major [n, d] matrix of T into a float tile of pitch p, zeros past n
// and d. float: cp.async, 16 bytes a copy where vec (d % 4 == 0 and every
// operand 16-byte aligned), else 4; bf16: loaded and converted by the
// threads (exact)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void copy4(float* out, const float* src, const float* row, int col,
                                      int d, bool rv, bool vec) {
  if (vec) {
    const bool ok = rv && col < d;
    cp_async16(out, ok ? row + col : src, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = rv && col + e < d;
      cp_async4(out + e, ok ? row + col + e : src, ok);
    }
  }
}
__device__ __forceinline__ void copy4(float* out, const bf16* src, const bf16* row, int col,
                                      int d, bool rv, bool) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[e] = rv && col + e < d ? __bfloat162float(row[col + e]) : 0.0f;
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int p, const T* __restrict__ src, int row0,
                                          int rows, int n, int col0, int width, int d,
                                          bool vec) {
  const int w4 = width >> 2;
  for (int i = threadIdx.x; i < rows * w4; i += blockDim.x) {
    const int r = i / w4, c = (i - r * w4) * 4;
    const int row = row0 + r;
    const bool rv = row < n;
    copy4(dst + r * p + c, src, rv ? src + (size_t)row * d : src, col0 + c, d, rv, vec);
  }
}

// two neighbouring outputs (columns col, col + 1) of row `row` of a [*, d] matrix
__device__ __forceinline__ void store2(bf16* out, size_t row, int col, int d, float x, float y) {
  bf16* p = out + row * d + col;
  if (col < d) p[0] = __float2bfloat16_rn(x);
  if (col + 1 < d) p[1] = __float2bfloat16_rn(y);
}
__device__ __forceinline__ void store2(float* out, size_t row, int col, int d, float x, float y) {
  float* p = out + row * d + col;
  if (col + 1 < d && (d & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    if (col < d) p[0] = x;
    if (col + 1 < d) p[1] = y;
  }
}

// ---------------------------------------------------------------------------
// forward: one block of pl.warps warps per (query tile, slice, column part),
// a warp 16 query rows. Units of the ring per key tile j: S's operands
// (resident: K_j; streaming: a chunk of Q and of K_j each), then
// V_j's columns of the part
// ---------------------------------------------------------------------------
template <typename T, int CW, int BK>
__global__ void __launch_bounds__(MAX_THREADS)
flash_f32_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int nq, int nk, int d, Plan pl,
                     float scale_log2, int vec) {
  constexpr bool X = std::is_same<T, bf16>::value;  // bf16 inputs are exact in TF32
  constexpr int NS = BK / 8, NO = CW / 8;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = pl.rows, kc = pl.kc, pc = kc + PAD, cols = pl.cols, po = cols + PAD;
  const bool stream = pl.stream != 0, vecb = vec != 0;
  const int nchunk = stream ? ceil_div(d, kc) : 1, U = nchunk + 1;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * rows, cbeg = blockIdx.z * cols;
  const T* qb = q + bh * nq * d;
  const T* kb = k + bh * nk * d;
  const T* vb = v + bh * nk * d;
  float* res = smem;  // Q, resident
  float* ring = smem + (stream ? 0 : rows * pc);
  const int slot = slot_floats(FWD, pl);

  auto load_unit = [&](int u) {
    float* s = ring + (u % STAGES) * slot;
    const int j = u / U, r = u - j * U;
    if (r == nchunk) {
      load_tile(s, po, vb, j * BK, BK, nk, cbeg, cols, d, vecb);
    } else if (stream) {
      load_tile(s, pc, qb, q0, rows, nq, r * kc, kc, d, vecb);
      load_tile(s + rows * pc, pc, kb, j * BK, BK, nk, r * kc, kc, d, vecb);
    } else {
      load_tile(s, pc, kb, j * BK, BK, nk, 0, kc, d, vecb);
    }
  };
  if (!stream) load_tile(res, pc, qb, q0, rows, nq, 0, kc, d, vecb);
  load_unit(0);
  cp_async_commit();

  const bool active = q0 + 16 * warp < nq;  // the same for the whole warp
  float acc[NO][4], s[NS][4];
  zero(acc);
  zero(s);
  // running max (raw scores) and sum of rows g and g + 8 of this warp's 16,
  // and the rescale of O by key tile j's new max
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f}, alpha[2] = {1.0f, 1.0f};
  const int total = ceil_div(nk, BK) * U;
  for (int u = 0; u < total; ++u) {
    if (u + 1 < total) {
      load_unit(u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j = u / U, r = u - j * U;
    const float* sl = ring + (u % STAGES) * slot;
    if (active && r < nchunk) {  // S += Q K^T over this unit's columns
      if (r == 0) zero(s);
      const float* a = stream ? sl : res;
      const float* b = stream ? sl + rows * pc : sl;
#pragma unroll 2
      for (int k0 = 0; k0 < kc; k0 += 8) {
        FragA fa;
        load_a<X>(fa, a, pc, 16 * warp, k0, lane);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          FragB fb;
          load_bt<X>(fb, b, pc, 8 * n, k0, lane);
          mma3<X, X>(s[n], fa, fb);
        }
      }
      if (r == nchunk - 1) {  // the online softmax of key tile j
        const int key0 = j * BK;
        if (key0 + BK > nk) {
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (key0 + 8 * n + 2 * (lane & 3) + (e & 1) >= nk) s[n][e] = -INFINITY;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
        }
        float neg[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = quad_max(mx[i]);
          alpha[i] = ex2((m[i] - mx[i]) * scale_log2);
          m[i] = mx[i];
          l[i] *= alpha[i];
          neg[i] = -mx[i] * scale_log2;
        }
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[n][e], scale_log2, neg[e >> 1]));
            s[n][e] = p;
            l[e >> 1] += p;
          }
      }
    } else if (active) {  // O = alpha O + P V over the part's columns
      FragA pa[NS];
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) acc_to_a(pa[kk], s[kk]);
      if (cols == CW)
        acc_product<true, X>(acc, pa, sl, po, 0, cols, alpha[0], alpha[1], lane);
      else
        acc_product<false, X>(acc, pa, sl, po, 0, cols, alpha[0], alpha[1], lane);
    }
    __syncthreads();  // this slot is free for the unit after next
  }
  if (!active) return;
  T* ob = o + bh * nq * d;
  const int row0 = q0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float sum = quad_sum(l[i]);
    if (row >= nq) continue;
    const float inv = 1.0f / sum;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * n < cols)
        store2(ob, row, cbeg + 8 * n + 2 * (lane & 3), d, acc[n][2 * i] * inv,
               acc[n][2 * i + 1] * inv);
    if (blockIdx.z == 0 && (lane & 3) == 0) lse[bh * nq + row] = m[i] * scale_log2 + log2f(sum);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// grid ceil(rows / 8), block 256: D[r] = sum_c dO[r][c] * O[r][c], a warp a
// row, lanes over c, then a fixed butterfly
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
flash_f32_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, long long rows, int d) {
  const long long r = (long long)blockIdx.x * (MAX_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    float a, b;
    if constexpr (std::is_same<T, bf16>::value) {
      a = __bfloat162float(o[r * d + c]);
      b = __bfloat162float(dout[r * d + c]);
    } else {
      a = o[r * d + c];
      b = dout[r * d + c];
    }
    s += a * b;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[r] = s;
}

// dK, dV: one block per (key tile, slice, column part x split), walking the
// split's query tiles; warp w owns keys 16 (w / wc).. and columns
// (w % wc) CW.. of the part. Units per query tile: S's operands (resident:
// Q_t and dO_t; streaming: a chunk of K, V, Q_t and dO_t each),
// then (streaming) Q_t's and dO_t's columns of the part; lse and D of the
// tile's queries at the end of the slot of its last S unit
template <typename T, int CW, int BQ>
__global__ void __launch_bounds__(MAX_THREADS)
flash_f32_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ part_k, float* __restrict__ part_v, int nq, int nk,
                      int d, Plan pl, int splits, float scale, float scale_log2, int vec) {
  constexpr bool X = std::is_same<T, bf16>::value;
  constexpr int NQ = BQ / 8, NO = CW / 8;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / pl.wc, cg = warp % pl.wc;
  const int rows = pl.rows, kc = pl.kc, pc = kc + PAD, cols = pl.cols, po = cols + PAD;
  const bool stream = pl.stream != 0, vecb = vec != 0;
  const int nchunk = stream ? ceil_div(d, kc) : 1, U = stream ? nchunk + 1 : 1;
  const int part = blockIdx.z / splits, z = blockIdx.z - part * splits;
  const int cbeg = part * cols;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * rows;
  const int ntq = ceil_div(nq, BQ);
  const int t_begin = (int)((long long)z * ntq / splits);
  const int t_end = (int)((long long)(z + 1) * ntq / splits);
  const T* qb = q + bh * nq * d;
  const T* gb = dout + bh * nq * d;
  const T* kb = k + bh * nk * d;
  const T* vb = v + bh * nk * d;
  const float* lb = lse + bh * nq;
  const float* db = delta + bh * nq;
  float* res = smem;  // K, V resident
  float* ring = smem + (stream ? 0 : 2 * rows * pc);
  const int slot = slot_floats(DKDV, pl);

  auto load_unit = [&](int u) {
    float* s = ring + (u % STAGES) * slot;
    const int t = t_begin + u / U, r = u % U;
    if (r == nchunk) {
      load_tile(s, po, qb, t * BQ, BQ, nq, cbeg, cols, d, vecb);
      load_tile(s + BQ * po, po, gb, t * BQ, BQ, nq, cbeg, cols, d, vecb);
      return;
    }
    if (stream) {
      load_tile(s, pc, kb, k0, rows, nk, r * kc, kc, d, vecb);
      load_tile(s + rows * pc, pc, vb, k0, rows, nk, r * kc, kc, d, vecb);
      load_tile(s + 2 * rows * pc, pc, qb, t * BQ, BQ, nq, r * kc, kc, d, vecb);
      load_tile(s + (2 * rows + BQ) * pc, pc, gb, t * BQ, BQ, nq, r * kc, kc, d, vecb);
    } else {
      load_tile(s, pc, qb, t * BQ, BQ, nq, 0, kc, d, vecb);
      load_tile(s + BQ * pc, pc, gb, t * BQ, BQ, nq, 0, kc, d, vecb);
    }
    if (r == nchunk - 1) {
      float* tail = s + slot - 2 * BQ;
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        const int row = t * BQ + i;
        tail[i] = row < nq ? lb[row] : 0.0f;
        tail[BQ + i] = row < nq ? db[row] : 0.0f;
      }
    }
  };
  if (!stream) {
    load_tile(res, pc, kb, k0, rows, nk, 0, kc, d, vecb);
    load_tile(res + rows * pc, pc, vb, k0, rows, nk, 0, kc, d, vecb);
  }
  load_unit(0);
  cp_async_commit();

  const bool active = k0 + 16 * rg < nk;
  float dka[NO][4], dva[NO][4], st[NQ][4], dpt[NQ][4];
  zero(dka);
  zero(dva);
  zero(st);
  zero(dpt);
  const int total = (t_end - t_begin) * U;
  for (int u = 0; u < total; ++u) {
    if (u + 1 < total) {
      load_unit(u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t = t_begin + u / U, r = u % U;
    const float* sl = ring + (u % STAGES) * slot;
    if (active && r < nchunk) {  // S^T = K Q^T, dP^T = V dO^T over this unit's columns
      if (r == 0) {
        zero(st);
        zero(dpt);
      }
      const float* ka = stream ? sl : res;
      const float* va = stream ? sl + rows * pc : res + rows * pc;
      const float* qa = stream ? sl + 2 * rows * pc : sl;
      const float* ga = stream ? sl + (2 * rows + BQ) * pc : sl + BQ * pc;
#pragma unroll 1  // unrolled, the CW 144 float32 instance spills (255 registers)
      for (int c0 = 0; c0 < kc; c0 += 8) {
        FragA fa;
        load_a<X>(fa, ka, pc, 16 * rg, c0, lane);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          FragB fb;
          load_bt<X>(fb, qa, pc, 8 * n, c0, lane);
          mma3<X, X>(st[n], fa, fb);
        }
        load_a<X>(fa, va, pc, 16 * rg, c0, lane);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          FragB fb;
          load_bt<X>(fb, ga, pc, 8 * n, c0, lane);
          mma3<X, X>(dpt[n], fa, fb);
        }
      }
      if (r == nchunk - 1) {  // P^T and dS^T of 16 keys x BQ queries
        const float* tail = sl + slot - 2 * BQ;
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * n + 2 * (lane & 3) + (e & 1);
            float p = ex2(fmaf(st[n][e], scale_log2, -tail[c]));
            if (t * BQ + c >= nq) p = 0.0f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - tail[BQ + c]);
          }
      }
    }
    if (active && (!stream || r == nchunk)) {  // dV += P^T dO, dK += dS^T Q
      const int p_ = stream ? po : pc;
      const float* qo = sl;
      const float* go = sl + BQ * p_;
      // one product at a time (dV, then dK), each n-tile's sum over the
      // tile's queries in a fresh accumulator folded into the total
      FragA fr[NQ];
      // unguarded (acc_product FULL) only where the score tiles leave the
      // registers room: CW x BQ <= 2304 (at CW 144, BQ 32 the float32
      // instance spills)
      const bool full = CW * BQ <= 2304 && cols == pl.wc * CW;
      const int c0 = cg * CW;
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) acc_to_a(fr[kk], st[kk]);
      if (full) acc_product<true, X>(dva, fr, go, p_, c0, cols, 1.0f, 1.0f, lane);
      else acc_product<false, X>(dva, fr, go, p_, c0, cols, 1.0f, 1.0f, lane);
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) acc_to_a(fr[kk], dpt[kk]);
      if (full) acc_product<true, X>(dka, fr, qo, p_, c0, cols, 1.0f, 1.0f, lane);
      else acc_product<false, X>(dka, fr, qo, p_, c0, cols, 1.0f, 1.0f, lane);
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * rg + (lane >> 2) + 8 * i;
    if (key >= nk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = cg * CW + 8 * n;
      if (c >= cols) continue;
      const int col = cbeg + c + 2 * (lane & 3);
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
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
flash_f32_reduce_kernel(const float* __restrict__ part_k, const float* __restrict__ part_v,
                        T* __restrict__ dk, T* __restrict__ dv, size_t n, int splits,
                        float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int z = 0; z < splits; ++z) {
      a += part_k[z * n + i];
      b += part_v[z * n + i];
    }
    if constexpr (std::is_same<T, bf16>::value) {
      dk[i] = __float2bfloat16_rn(a * scale);
      dv[i] = __float2bfloat16_rn(b);
    } else {
      dk[i] = a * scale;
      dv[i] = b;
    }
  }
}

// dQ: one block per (query tile, slice, column part), a warp 16 query rows.
// Units per key tile j: resident: K_j and V_j (S, dP and dQ from them);
// streaming: a chunk of Q, dO, K_j and V_j each, then K_j's
// columns of the part
template <typename T, int CW, int BK>
__global__ void __launch_bounds__(MAX_THREADS)
flash_f32_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int nq, int nk, int d,
                    Plan pl, float scale, float scale_log2, int vec) {
  constexpr bool X = std::is_same<T, bf16>::value;
  constexpr int NS = BK / 8, NO = CW / 8;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = pl.rows, kc = pl.kc, pc = kc + PAD, cols = pl.cols, po = cols + PAD;
  const bool stream = pl.stream != 0, vecb = vec != 0;
  const int nchunk = stream ? ceil_div(d, kc) : 1, U = stream ? nchunk + 1 : 1;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * rows, cbeg = blockIdx.z * cols;
  const T* qb = q + bh * nq * d;
  const T* gb = dout + bh * nq * d;
  const T* kb = k + bh * nk * d;
  const T* vb = v + bh * nk * d;
  float* res = smem;  // Q, dO resident
  float* ring = smem + (stream ? 0 : 2 * rows * pc);
  const int slot = slot_floats(DQ, pl);

  auto load_unit = [&](int u) {
    float* s = ring + (u % STAGES) * slot;
    const int j = u / U, r = u % U;
    if (!stream) {
      load_tile(s, pc, kb, j * BK, BK, nk, 0, kc, d, vecb);
      load_tile(s + BK * pc, pc, vb, j * BK, BK, nk, 0, kc, d, vecb);
    } else if (r < nchunk) {
      load_tile(s, pc, qb, q0, rows, nq, r * kc, kc, d, vecb);
      load_tile(s + rows * pc, pc, gb, q0, rows, nq, r * kc, kc, d, vecb);
      load_tile(s + 2 * rows * pc, pc, kb, j * BK, BK, nk, r * kc, kc, d, vecb);
      load_tile(s + (2 * rows + BK) * pc, pc, vb, j * BK, BK, nk, r * kc, kc, d, vecb);
    } else {
      load_tile(s, po, kb, j * BK, BK, nk, cbeg, cols, d, vecb);
    }
  };
  if (!stream) {
    load_tile(res, pc, qb, q0, rows, nq, 0, kc, d, vecb);
    load_tile(res + rows * pc, pc, gb, q0, rows, nq, 0, kc, d, vecb);
  }
  load_unit(0);
  cp_async_commit();

  const bool active = q0 + 16 * warp < nq;
  const int row0 = q0 + 16 * warp + (lane >> 2);  // this lane's rows: row0, row0 + 8
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lrow[i] = row < nq ? lse[bh * nq + row] : 0.0f;
    drow[i] = row < nq ? delta[bh * nq + row] : 0.0f;
  }
  float acc[NO][4], s[NS][4], dp[NS][4];
  zero(acc);
  zero(s);
  zero(dp);
  const int total = ceil_div(nk, BK) * U;
  for (int u = 0; u < total; ++u) {
    if (u + 1 < total) {
      load_unit(u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j = u / U, r = u % U;
    const float* sl = ring + (u % STAGES) * slot;
    if (active && r < nchunk) {  // S = Q K^T, dP = dO V^T over this unit's columns
      if (r == 0) {
        zero(s);
        zero(dp);
      }
      const float* qa = stream ? sl : res;
      const float* ga = stream ? sl + rows * pc : res + rows * pc;
      const float* ka = stream ? sl + 2 * rows * pc : sl;
      const float* va = stream ? sl + (2 * rows + BK) * pc : sl + BK * pc;
#pragma unroll 2
      for (int c0 = 0; c0 < kc; c0 += 8) {
        FragA fa;
        load_a<X>(fa, qa, pc, 16 * warp, c0, lane);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          FragB fb;
          load_bt<X>(fb, ka, pc, 8 * n, c0, lane);
          mma3<X, X>(s[n], fa, fb);
        }
        load_a<X>(fa, ga, pc, 16 * warp, c0, lane);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          FragB fb;
          load_bt<X>(fb, va, pc, 8 * n, c0, lane);
          mma3<X, X>(dp[n], fa, fb);
        }
      }
      if (r == nchunk - 1) {  // dS of 16 queries x BK keys, into s
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * BK + 8 * n + 2 * (lane & 3) + (e & 1);
            float p = ex2(fmaf(s[n][e], scale_log2, -lrow[e >> 1]));
            if (key >= nk) p = 0.0f;
            s[n][e] = p * (dp[n][e] - drow[e >> 1]);
          }
      }
    }
    if (active && (!stream || r == nchunk)) {  // dQ += dS K over the part's columns
      const int p_ = stream ? po : pc;
      FragA da[NS];
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) acc_to_a(da[kk], s[kk]);
      // unguarded where it does not spill (CW x BK <= 2304, as in dK/dV)
      if (CW * BK <= 2304 && cols == CW)
        acc_product<true, X>(acc, da, sl, p_, 0, cols, 1.0f, 1.0f, lane);
      else
        acc_product<false, X>(acc, da, sl, p_, 0, cols, 1.0f, 1.0f, lane);
    }
    __syncthreads();
  }
  if (!active) return;
  T* out = dq + bh * nq * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= nq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * n < cols)
        store2(out, row, cbeg + 8 * n + 2 * (lane & 3), d, acc[n][2 * i] * scale,
               acc[n][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t prepare(K kernel, const Plan& p) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int TIER>
int launch_fwd(const T* q, const T* k, const T* v, T* o, float* lse, int bh, int nq, int nk,
               int d, float scale_log2, int vec, cudaStream_t stream) {
  const Plan p = make_plan(FWD, d, std::is_same<T, bf16>::value);
  auto kernel = flash_f32_fwd_kernel<T, CW_OF[FWD][TIER], BK_OF[FWD][TIER]>;
  cudaError_t err = prepare(kernel, p);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(ceil_div(nq, p.rows), bh, p.parts), 32 * p.warps, p.smem, stream>>>(
      q, k, v, o, lse, nq, nk, d, p, scale_log2, vec);
  return (int)cudaGetLastError();
}

template <typename T, int TIER>
int launch_dkdv_dq(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                   const float* delta, T* dq, T* dk, T* dv, float* part_k, float* part_v,
                   int bh, int nq, int nk, int d, float scale, float scale_log2, int splits,
                   int vec, cudaStream_t stream) {
  const int is_bf16 = std::is_same<T, bf16>::value;
  const Plan pk = make_plan(DKDV, d, is_bf16);
  if (splits < 1 || splits > ceil_div(nq, pk.bk) || (splits > 1 && (!part_k || !part_v)))
    return (int)cudaErrorInvalidValue;
  auto kv_kernel = flash_f32_dkdv_kernel<T, CW_OF[DKDV][TIER], BK_OF[DKDV][TIER]>;
  cudaError_t err = prepare(kv_kernel, pk);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<dim3(ceil_div(nk, pk.rows), bh, pk.parts * splits), 32 * pk.warps, pk.smem,
              stream>>>(q, k, v, dout, lse, delta, dk, dv, part_k, part_v, nq, nk, d, pk,
                        splits, scale, scale_log2, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const size_t n = (size_t)bh * nk * d;
    const int blocks = (int)(n / MAX_THREADS + 1 < 132 * 8 ? n / MAX_THREADS + 1 : 132 * 8);
    flash_f32_reduce_kernel<T><<<blocks, MAX_THREADS, 0, stream>>>(part_k, part_v, dk, dv, n,
                                                                   splits, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const Plan pq = make_plan(DQ, d, is_bf16);
  auto q_kernel = flash_f32_dq_kernel<T, CW_OF[DQ][TIER], BK_OF[DQ][TIER]>;
  err = prepare(q_kernel, pq);
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3(ceil_div(nq, pq.rows), bh, pq.parts), 32 * pq.warps, pq.smem, stream>>>(
      q, k, v, dout, lse, delta, dq, nq, nk, d, pq, scale, scale_log2, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int nq, int nk,
        int d, float scale, cudaStream_t stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  const int vec = !std::is_same<T, bf16>::value && d % 4 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v);
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v;
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_fwd<T, 2>(qt, kt, vt, (T*)o, (float*)lse, bh, nq, nk, d, scale_log2, vec,
                            stream);
  } else {
    switch (tier_of(d, 0)) {
      case 0: return launch_fwd<T, 0>(qt, kt, vt, (T*)o, (float*)lse, bh, nq, nk, d, scale_log2, vec, stream);
      case 1: return launch_fwd<T, 1>(qt, kt, vt, (T*)o, (float*)lse, bh, nq, nk, d, scale_log2, vec, stream);
      default: return launch_fwd<T, 2>(qt, kt, vt, (T*)o, (float*)lse, bh, nq, nk, d, scale_log2, vec, stream);
    }
  }
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, void* part_k, void* part_v,
        int bh, int nq, int nk, int d, float scale, int splits, cudaStream_t stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  const long long rows = (long long)bh * nq;
  flash_f32_pre_kernel<T><<<(unsigned)((rows + 7) / 8), MAX_THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = !std::is_same<T, bf16>::value && d % 4 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(dout);
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v, *gt = (const T*)dout;
#define F32_BWD_ARGS                                                                        \
  qt, kt, vt, gt, (const float*)lse, (const float*)delta, (T*)dq, (T*)dk, (T*)dv,           \
      (float*)part_k, (float*)part_v, bh, nq, nk, d, scale, scale_log2, splits, vec, stream
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dkdv_dq<T, 2>(F32_BWD_ARGS);
  } else {
    switch (tier_of(d, 0)) {
      case 0: return launch_dkdv_dq<T, 0>(F32_BWD_ARGS);
      case 1: return launch_dkdv_dq<T, 1>(F32_BWD_ARGS);
      default: return launch_dkdv_dq<T, 2>(F32_BWD_ARGS);
    }
  }
#undef F32_BWD_ARGS
}

bool bad_shape(int bh, int nq, int nk, int d) {
  return bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || bh > 65535;
}

}  // namespace

extern "C" {

// The launch plan of kernel 0 (forward), 1 (dQ) or 2 (dK/dV) at head dim d
// for float32 (bf16 0) or bf16 (bf16 1) inputs: out[0..9] = cw, bk, warps,
// wc, rows, stream, kc, cols, parts, smem (ops/flash_attention.py f32_plan
// holds the same arithmetic). Returns 0, or -1 for a kernel that is not one
// of the three.
int flash_f32_plan(int kernel, int d, int bf16, int* out) {
  if (kernel < 0 || kernel > 2 || d <= 0) return -1;
  const Plan p = make_plan(kernel, d, bf16);
  const int vals[10] = {p.cw, p.bk, p.warps, p.wc, p.rows, p.stream, p.kc, p.cols, p.parts, p.smem};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

// q [bh, nq, d], k and v [bh, nk, d], all contiguous, float32 (bf16 0) or
// bf16 (bf16 1) -> o [bh, nq, d] of the same type, lse [bh, nq] float32
// (base 2); scale >= 0.
int flash_f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                  int nq, int nk, int d, float scale, int bf16, void* stream) {
  if (bad_shape(bh, nq, nk, d) || !(scale >= 0.0f)) return (int)cudaErrorInvalidValue;
  return bf16 ? fwd<__nv_bfloat16>(q, k, v, o, lse, bh, nq, nk, d, scale, (cudaStream_t)stream)
              : fwd<float>(q, k, v, o, lse, bh, nq, nk, d, scale, (cudaStream_t)stream);
}

// The backward: D into delta [bh, nq] float32, then dK/dV (its query range
// split `splits` ways, the partials in part_k and part_v [splits, bh, nk, d]
// float32 when splits > 1, then summed in split order), then dQ, each of q's
// type.
int flash_f32_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv, void* part_k,
                  void* part_v, int bh, int nq, int nk, int d, float scale, int splits, int bf16,
                  void* stream) {
  if (bad_shape(bh, nq, nk, d)) return (int)cudaErrorInvalidValue;
  return bf16 ? bwd<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, part_k, part_v, bh,
                                   nq, nk, d, scale, splits, (cudaStream_t)stream)
              : bwd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, part_k, part_v, bh, nq, nk,
                           d, scale, splits, (cudaStream_t)stream);
}

}  // extern "C"
