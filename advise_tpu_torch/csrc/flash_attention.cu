// Flash attention, forward and backward, hand-written for Hopper (sm_90a)
// tensor cores through nvcuda::wmma (bf16 16x16x16, float32 accumulation).
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
// kernels mask the ragged nq and nk edges themselves and take d as it is,
// zero-padding it to Dp = 16 * ceil(d / 16) inside shared memory only
// (exact: zero columns add nothing to Q K^T and are not stored).
//
// Bound on the card: 4 nq nk d FLOP forward and 10 nq nk d backward per
// slice (the backward recomputes S and P), against reading Q, K, V (and O,
// dO) once. At MViT-L 32x312's shapes (nq 1,600-97,344, nk 1,600-6,400, d
// 72-576) that is 200-1,000+ FLOP per byte: tensor-core bound, at ~16 ms
// per train step at the bf16 peak (989 TFLOP/s).
//
// Design, a simple one that is right first (wgmma, TMA and warp
// specialisation are later work):
//  - eight warps per block: a block's shared memory leaves room for one or
//    two blocks on an SM, so the warps of one block must hide the latency;
//    every product is wmma 16x16x16 on tiles staged in shared memory, with
//    row pitches of Dp + 8 (bf16) and Dp + 4 (float32) to keep wmma's
//    32-byte alignment and spread the banks;
//  - forward: one block per (slice, BQ query rows) loops over BK-key tiles
//    with the online softmax (running max and sum per row, in base 2); the
//    float32 O accumulator lives in shared memory and is rescaled there,
//    since wmma does not expose its accumulator's layout;
//  - backward: a preprocess kernel computes D; the dK/dV kernel takes one
//    block per (slice, BK keys) and loops over the query tiles; the dQ kernel
//    takes one block per (slice, BQ queries) and loops over the key tiles.
//    Both recompute P from lse. Each output element is owned by one block:
//    no atomics, so the backward is deterministic;
//  - the tile sizes follow d (tile_config): the largest of 64x64, 32x64,
//    32x32, 16x32, 16x16 whose shared memory fits the 227 KB a block may use.
//    At d 576 a 64-row float32 accumulator alone is 147 KB, so the forward
//    takes 32 x 32 there, the dK/dV kernel 16 keys x 32 queries and the dQ
//    kernel 16 queries x 32 keys; d <= 288 takes 64 x 64 forward.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. Each C entry point launches on the given stream and
// returns the first cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr int NCFG = 5;
constexpr int CFG_ROWS[NCFG] = {64, 32, 32, 16, 16};  // the block's own rows
constexpr int CFG_INNER[NCFG] = {64, 64, 32, 32, 16};  // rows of the loop's tiles

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows x Dp tile of a row-major [n, d] bf16 matrix into shared memory of
// pitch ld, from row row0; rows past n and columns past d are zeros.
__device__ inline void load_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                                 int row0, int rows, int n, int d, int Dp) {
  if ((d & 7) == 0) {  // 16-byte vectors (the wrapper checks alignment)
    const int vecs = Dp / 8;
    for (int i = threadIdx.x; i < rows * vecs; i += THREADS) {
      const int r = i / vecs;
      const int c = (i - r * vecs) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < n && c < d)
        val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dp; i += THREADS) {
      const int r = i / Dp;
      const int c = i - r * Dp;
      bf16 val = __float2bfloat16(0.0f);
      if (row0 + r < n && c < d) val = src[(size_t)(row0 + r) * d + c];
      dst[r * ld + c] = val;
    }
  }
}

// C[M x N] (float32, pitch ldc) = A B over K, each warp taking 16x16 output
// tiles in turn. A is [M, K] row-major (pitch lda) or, with A_COL, given as
// its transpose [K, M] row-major; B is [K, N] row-major (pitch ldb) or,
// with B_COL, given as its transpose [N, K] row-major. ACC adds to C.
template <bool A_COL, bool B_COL, bool ACC>
__device__ inline void mma_tiles(float* C, int ldc, const bf16* A, int lda,
                                 const bf16* B, int ldb, int M, int N, int K) {
  typedef typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type LA;
  typedef typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type LB;
  const int warp = threadIdx.x / 32;
  const int tn = N / 16;
  for (int t = warp; t < (M / 16) * tn; t += WARPS) {
    const int m0 = (t / tn) * 16;
    const int n0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (ACC)
      wmma::load_matrix_sync(acc, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(a, A_COL ? A + k0 * lda + m0 : A + m0 * lda + k0, lda);
      wmma::load_matrix_sync(b, B_COL ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + m0 * ldc + n0, acc, ldc, wmma::mem_row_major);
  }
}

// shared-memory pitches
__host__ __device__ inline int pitch_h(int cols) { return cols + 8; }  // bf16
__host__ __device__ inline int pitch_f(int cols) { return cols + 4; }  // float32

size_t fwd_smem(int BQ, int BK, int Dp) {
  return 2 * (size_t)(BQ + 2 * BK) * pitch_h(Dp) + 4 * (size_t)BQ * pitch_f(Dp) +
         4 * (size_t)BQ * pitch_f(BK) + 2 * (size_t)BQ * pitch_h(BK) + 4 * 3 * (size_t)BQ;
}

size_t dkdv_smem(int BK, int BQ, int Dp) {
  return 2 * 2 * (size_t)BK * pitch_h(Dp) + 2 * 4 * (size_t)BK * pitch_f(Dp) +
         2 * 2 * (size_t)BQ * pitch_h(Dp) + 2 * 4 * (size_t)BQ * pitch_f(BK) +
         2 * 2 * (size_t)BQ * pitch_h(BK) + 2 * 4 * (size_t)BQ;
}

size_t dq_smem(int BQ, int BK, int Dp) {
  return 2 * 2 * (size_t)BQ * pitch_h(Dp) + 4 * (size_t)BQ * pitch_f(Dp) +
         2 * 2 * (size_t)BK * pitch_h(Dp) + 2 * 4 * (size_t)BQ * pitch_f(BK) +
         2 * (size_t)BQ * pitch_h(BK) + 2 * 4 * (size_t)BQ;
}

// the first configuration whose shared memory fits, or -1
int pick(size_t (*smem)(int, int, int), int Dp) {
  for (int i = 0; i < NCFG; ++i)
    if (smem(CFG_ROWS[i], CFG_INNER[i], Dp) <= (size_t)SMEM_LIMIT) return i;
  return -1;
}

// ---------------------------------------------------------------------------
// forward: one block per (BQ query rows, slice)
// ---------------------------------------------------------------------------
template <int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int nq, int nk, int d, int Dp,
                 float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = pitch_h(Dp), ldf = pitch_f(Dp), lds = pitch_f(BK), ldp = pitch_h(BK);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * ldh;
  bf16* sV = sK + BK * ldh;
  float* sO = reinterpret_cast<float*>(sV + BK * ldh);
  float* sS = sO + BQ * ldf;
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * lds);
  float* sM = reinterpret_cast<float*>(sP + BQ * ldp);
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kb = k + bh * nk * d;
  const bf16* vb = v + bh * nk * d;

  load_tile(sQ, ldh, q + bh * nq * d, q0, BQ, nq, d, Dp);
  for (int i = threadIdx.x; i < BQ * ldf; i += THREADS) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.0f;
  }

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // the previous tile's sK, sV and sP are free
    load_tile(sK, ldh, kb, k0, BK, nk, d, Dp);
    load_tile(sV, ldh, vb, k0, BK, nk, d, Dp);
    __syncthreads();
    mma_tiles<false, true, false>(sS, lds, sQ, ldh, sK, ldh, BQ, BK, Dp);  // S = Q K^T
    __syncthreads();
    for (int r = warp; r < BQ; r += WARPS) {  // online softmax, one warp a row
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) {
        const float s = (k0 + c < nk) ? sS[r * lds + c] * scale_log2 : -INFINITY;
        sS[r * lds + c] = s;
        mx = fmaxf(mx, s);
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(mx));  // finite: column k0 is a key
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float p = exp2f(sS[r * lds + c] - m_new);
        sP[r * ldp + c] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * Dp; i += THREADS) {
      const int r = i / Dp;
      sO[r * ldf + (i - r * Dp)] *= sA[r];
    }
    __syncthreads();
    mma_tiles<false, false, true>(sO, ldf, sP, ldp, sV, ldh, BQ, Dp, BK);  // O += P V
  }
  __syncthreads();
  bf16* ob = o + bh * nq * d;
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d;
    const int c = i - r * d;
    if (q0 + r < nq) ob[(size_t)(q0 + r) * d + c] = __float2bfloat16(sO[r * ldf + c] / sL[r]);
  }
  for (int r = threadIdx.x; r < BQ; r += THREADS)
    if (q0 + r < nq) lse[bh * nq + q0 + r] = sM[r] + log2f(sL[r]);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D = rowsum(dO o O), one warp a row
__global__ void __launch_bounds__(THREADS)
flash_bwd_pre_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* orow = o + (size_t)row * d;
  const bf16* grow = dout + (size_t)row * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += __bfloat162float(orow[c]) * __bfloat162float(grow[c]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// P (and dS when dp is given) of one [BQ, BK] tile from S and dP in place:
// p = exp2(S * scale_log2 - lse), zero outside the nq x nk grid.
template <int BQ, int BK>
__device__ inline void probs(const float* sS, const float* sdP, int lds, bf16* sP,
                             bf16* sdS, int ldp, const float* sLse, const float* sD,
                             int q0, int k0, int nq, int nk, float scale_log2) {
  for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
    const int r = i / BK;
    const int c = i - r * BK;
    const bool valid = (q0 + r < nq) && (k0 + c < nk);
    const float p = valid ? exp2f(sS[r * lds + c] * scale_log2 - sLse[r]) : 0.0f;
    if (sP != nullptr) sP[r * ldp + c] = __float2bfloat16(p);
    sdS[r * ldp + c] = __float2bfloat16(p * (sdP[r * lds + c] - sD[r]));
  }
}

// dK, dV: one block per (BK key rows, slice), looping over the query tiles
template <int BK, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int nq, int nk,
                      int d, int Dp, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = pitch_h(Dp), ldf = pitch_f(Dp), lds = pitch_f(BK), ldp = pitch_h(BK);
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * ldh;
  float* sdK = reinterpret_cast<float*>(sV + BK * ldh);
  float* sdV = sdK + BK * ldf;
  bf16* sQ = reinterpret_cast<bf16*>(sdV + BK * ldf);
  bf16* sdO = sQ + BQ * ldh;
  float* sS = reinterpret_cast<float*>(sdO + BQ * ldh);
  float* sdP = sS + BQ * lds;
  bf16* sP = reinterpret_cast<bf16*>(sdP + BQ * lds);
  bf16* sdS = sP + BQ * ldp;
  float* sLse = reinterpret_cast<float*>(sdS + BQ * ldp);
  float* sD = sLse + BQ;

  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const bf16* qb = q + bh * nq * d;
  const bf16* gb = dout + bh * nq * d;
  const float* lb = lse + bh * nq;
  const float* db = delta + bh * nq;

  load_tile(sK, ldh, k + bh * nk * d, k0, BK, nk, d, Dp);
  load_tile(sV, ldh, v + bh * nk * d, k0, BK, nk, d, Dp);
  for (int i = threadIdx.x; i < BK * ldf; i += THREADS) {
    sdK[i] = 0.0f;
    sdV[i] = 0.0f;
  }
  for (int q0 = 0; q0 < nq; q0 += BQ) {
    __syncthreads();
    load_tile(sQ, ldh, qb, q0, BQ, nq, d, Dp);
    load_tile(sdO, ldh, gb, q0, BQ, nq, d, Dp);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      sLse[r] = q0 + r < nq ? lb[q0 + r] : 0.0f;
      sD[r] = q0 + r < nq ? db[q0 + r] : 0.0f;
    }
    __syncthreads();
    mma_tiles<false, true, false>(sS, lds, sQ, ldh, sK, ldh, BQ, BK, Dp);    // S = Q K^T
    mma_tiles<false, true, false>(sdP, lds, sdO, ldh, sV, ldh, BQ, BK, Dp);  // dP = dO V^T
    __syncthreads();
    probs<BQ, BK>(sS, sdP, lds, sP, sdS, ldp, sLse, sD, q0, k0, nq, nk, scale_log2);
    __syncthreads();
    mma_tiles<true, false, true>(sdV, ldf, sP, ldp, sdO, ldh, BK, Dp, BQ);  // dV += P^T dO
    mma_tiles<true, false, true>(sdK, ldf, sdS, ldp, sQ, ldh, BK, Dp, BQ);  // dK += dS^T Q
  }
  __syncthreads();
  bf16* dkb = dk + bh * nk * d;
  bf16* dvb = dv + bh * nk * d;
  for (int i = threadIdx.x; i < BK * d; i += THREADS) {
    const int r = i / d;
    const int c = i - r * d;
    if (k0 + r < nk) {
      dkb[(size_t)(k0 + r) * d + c] = __float2bfloat16(sdK[r * ldf + c] * scale);
      dvb[(size_t)(k0 + r) * d + c] = __float2bfloat16(sdV[r * ldf + c]);
    }
  }
}

// dQ: one block per (BQ query rows, slice), looping over the key tiles
template <int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int nq, int nk, int d, int Dp, float scale,
                    float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = pitch_h(Dp), ldf = pitch_f(Dp), lds = pitch_f(BK), ldp = pitch_h(BK);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * ldh;
  float* sdQ = reinterpret_cast<float*>(sdO + BQ * ldh);
  bf16* sK = reinterpret_cast<bf16*>(sdQ + BQ * ldf);
  bf16* sV = sK + BK * ldh;
  float* sS = reinterpret_cast<float*>(sV + BK * ldh);
  float* sdP = sS + BQ * lds;
  bf16* sdS = reinterpret_cast<bf16*>(sdP + BQ * lds);
  float* sLse = reinterpret_cast<float*>(sdS + BQ * ldp);
  float* sD = sLse + BQ;

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* kb = k + bh * nk * d;
  const bf16* vb = v + bh * nk * d;

  load_tile(sQ, ldh, q + bh * nq * d, q0, BQ, nq, d, Dp);
  load_tile(sdO, ldh, dout + bh * nq * d, q0, BQ, nq, d, Dp);
  for (int i = threadIdx.x; i < BQ * ldf; i += THREADS) sdQ[i] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    sLse[r] = q0 + r < nq ? lse[bh * nq + q0 + r] : 0.0f;
    sD[r] = q0 + r < nq ? delta[bh * nq + q0 + r] : 0.0f;
  }
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile(sK, ldh, kb, k0, BK, nk, d, Dp);
    load_tile(sV, ldh, vb, k0, BK, nk, d, Dp);
    __syncthreads();
    mma_tiles<false, true, false>(sS, lds, sQ, ldh, sK, ldh, BQ, BK, Dp);    // S = Q K^T
    mma_tiles<false, true, false>(sdP, lds, sdO, ldh, sV, ldh, BQ, BK, Dp);  // dP = dO V^T
    __syncthreads();
    probs<BQ, BK>(sS, sdP, lds, nullptr, sdS, ldp, sLse, sD, q0, k0, nq, nk, scale_log2);
    __syncthreads();
    mma_tiles<false, false, true>(sdQ, ldf, sdS, ldp, sK, ldh, BQ, Dp, BK);  // dQ += dS K
  }
  __syncthreads();
  bf16* dqb = dq + bh * nq * d;
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) {
    const int r = i / d;
    const int c = i - r * d;
    if (q0 + r < nq) dqb[(size_t)(q0 + r) * d + c] = __float2bfloat16(sdQ[r * ldf + c] * scale);
  }
}

// launch kernel<CFG_ROWS[cfg], CFG_INNER[cfg]> with its dynamic shared memory
#define FLASH_DISPATCH(cfg, KERNEL, SMEM, GRID_X, ...)                               \
  do {                                                                               \
    switch (cfg) {                                                                   \
      case 0: FLASH_LAUNCH(KERNEL, 64, 64, SMEM, GRID_X, __VA_ARGS__); break;        \
      case 1: FLASH_LAUNCH(KERNEL, 32, 64, SMEM, GRID_X, __VA_ARGS__); break;        \
      case 2: FLASH_LAUNCH(KERNEL, 32, 32, SMEM, GRID_X, __VA_ARGS__); break;        \
      case 3: FLASH_LAUNCH(KERNEL, 16, 32, SMEM, GRID_X, __VA_ARGS__); break;        \
      default: FLASH_LAUNCH(KERNEL, 16, 16, SMEM, GRID_X, __VA_ARGS__); break;       \
    }                                                                                \
  } while (0)

#define FLASH_LAUNCH(KERNEL, R, I, SMEM, GRID_X, ...)                                \
  do {                                                                               \
    const size_t bytes = SMEM(R, I, Dp);                                             \
    cudaFuncSetAttribute(KERNEL<R, I>, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                         (int)bytes);                                                \
    KERNEL<R, I><<<dim3(ceil_div(GRID_X, R), bh), THREADS, bytes, st>>>(__VA_ARGS__); \
  } while (0)

}  // namespace

extern "C" {

// The tile configuration of each kernel for head dim d, as (rows, inner)
// pairs: out[0..1] forward (BQ, BK), out[2..3] dK/dV (BK, BQ), out[4..5] dQ
// (BQ, BK). Returns 0, or -1 when no configuration fits shared memory.
int flash_tiles(int d, int* out) {
  const int Dp = ceil_div(d, 16) * 16;
  const int cfg[3] = {pick(fwd_smem, Dp), pick(dkdv_smem, Dp), pick(dq_smem, Dp)};
  for (int i = 0; i < 3; ++i) {
    if (cfg[i] < 0) return -1;
    out[2 * i] = CFG_ROWS[cfg[i]];
    out[2 * i + 1] = CFG_INNER[cfg[i]];
  }
  return 0;
}

// q [bh, nq, d], k and v [bh, nk, d] bf16, contiguous, 16-byte aligned when
// d % 8 == 0 -> o [bh, nq, d] bf16, lse [bh, nq] float32 (base 2).
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
              int nq, int nk, int d, float scale, void* stream) {
  const int Dp = ceil_div(d, 16) * 16;
  const int cfg = pick(fwd_smem, Dp);
  if (cfg < 0) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(cfg, flash_fwd_kernel, fwd_smem, nq, (const bf16*)q, (const bf16*)k,
                 (const bf16*)v, (bf16*)o, (float*)lse, nq, nk, d, Dp, scale_log2);
  return (int)cudaGetLastError();
}

// The gradients of flash_fwd: from q, k, v, its o and lse and the output
// gradient dout (all as flash_fwd's) -> dq, dk, dv bf16 in q's, k's and v's
// shapes, through delta [bh, nq] float32 scratch.
int flash_bwd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
              int bh, int nq, int nk, int d, float scale, void* stream) {
  const int Dp = ceil_div(d, 16) * 16;
  const int cfg_kv = pick(dkdv_smem, Dp);
  const int cfg_q = pick(dq_smem, Dp);
  if (cfg_kv < 0 || cfg_q < 0) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = bh * nq;
  flash_bwd_pre_kernel<<<ceil_div(rows, WARPS), THREADS, 0, st>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FLASH_DISPATCH(cfg_kv, flash_bwd_dkdv_kernel, dkdv_smem, nk, (const bf16*)q,
                 (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
                 (const float*)delta, (bf16*)dk, (bf16*)dv, nq, nk, d, Dp, scale,
                 scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FLASH_DISPATCH(cfg_q, flash_bwd_dq_kernel, dq_smem, nq, (const bf16*)q, (const bf16*)k,
                 (const bf16*)v, (const bf16*)dout, (const float*)lse, (const float*)delta,
                 (bf16*)dq, nq, nk, d, Dp, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // extern "C"
