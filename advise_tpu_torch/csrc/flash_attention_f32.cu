// Flash attention, forward and backward, in float32 on the CUDA cores: the
// K4 pair for the inputs the tensor-core kernels of flash_attention.cu do
// not take, float32 q, k, v at any head dim and bf16 above 576.
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
// Inputs of type T (float or bf16, converted to float on load), every
// product and sum in float32, outputs written as T; lse and D float32.
//
// Bound on the card: 4 nq nk d FLOP forward and 10 nq nk d backward per
// slice at the 67 TFLOP/s float32 rate of the CUDA cores (the tensor cores
// take float32 only as TF32, which would round the inputs), against reading
// Q, K, V (O, dO) once: operation-bound at every shape MViT-L runs.
//
// Design (a first, plain one: right before fast):
//  - a block of 256 threads owns 32 rows (queries for the forward and dQ,
//    keys for dK/dV) and walks the other side in tiles of 32; a 32 x 32
//    score tile is 4 values a thread, its dot products over d taken in
//    chunks of 32 columns staged in shared memory (rows padded to 33 floats
//    so a warp's reads fall on distinct banks);
//  - the forward's online softmax runs a row a warp (a lane a key of the
//    tile): row max and sum by warp shuffles, the rescale factor and the
//    row's running max and sum in shared memory; its base-2 lse is saved as
//    the tensor-core forward saves it;
//  - the float32 output tile (O, dQ, or dK and dV) would not fit registers
//    at these head dims, so it lives in shared memory, [32][dout], and is
//    updated in chunks of 128 columns, 16 a thread. Where d exceeds what a
//    block holds (1024 columns forward and dQ, 512 for dK and dV together),
//    grid z splits d and each block recomputes the scores for its columns;
//  - backward: a preprocess kernel computes D a warp a row; the dK/dV
//    kernel walks all query tiles and the dQ kernel all key tiles, each
//    output element written by one thread of one block after a sum in a
//    fixed order: no atomics, so the backward is deterministic.
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

constexpr int NT = 256;       // threads a block
constexpr int BR = 32;        // rows a block owns, and rows of a walked tile
constexpr int DC = 32;        // columns of a dot-product chunk
constexpr int LD = DC + 1;    // padded row of a staged chunk or score tile
constexpr int VC = 128;       // output columns updated a pass: 16 a thread
constexpr int OUT_COLS = 1024;     // float32 output columns a block holds (forward, dQ)
constexpr int OUT_COLS_KV = 512;   // dK and dV columns a block holds, each

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Scratch {
  float a[BR][LD];   // a chunk of the block's rows
  float b[BR][LD];   // a chunk of the walked tile's rows
  float p[BR][LD];   // P (forward: its scores first)
  float ds[BR][LD];  // dS
  float x[BR][VC];   // a column chunk of V, dO, Q or K
  float row0[BR];    // per block row: running max (forward), lse (backward)
  float row1[BR];    // running sum (forward), D (backward)
  float row2[BR];    // rescale factor (forward)
};

// s[u][v] += dot(a row ty + 16 u, b row tx + 16 v) over d, for the thread
// (ty, tx) = (tid / 16, tid % 16); rows past na (nb) read as zero.
template <typename T>
__device__ void dot_tile(const T* a, int na, const T* b, int nb, int d, Scratch& sm,
                         float (&s)[2][2]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int u = 0; u < 2; ++u) s[u][0] = s[u][1] = 0.f;
  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < BR * DC; e += NT) {
      const int r = e / DC, c = e % DC;
      const bool col = c0 + c < d;
      sm.a[r][c] = r < na && col ? ld(a + (size_t)r * d + c0 + c) : 0.f;
      sm.b[r][c] = r < nb && col ? ld(b + (size_t)r * d + c0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < DC; ++c) {
      const float a0 = sm.a[ty][c], a1 = sm.a[ty + 16][c];
      const float b0 = sm.b[tx][c], b1 = sm.b[tx + 16][c];
      s[0][0] += a0 * b0;
      s[0][1] += a0 * b1;
      s[1][0] += a1 * b0;
      s[1][1] += a1 * b1;
    }
  }
}

// Stage columns [c0, c0 + VC) of rows [0, n) of src (row stride d, columns
// past cend zero) into sm.x.
template <typename T>
__device__ void stage_cols(const T* src, int n, int d, int c0, int cend, Scratch& sm) {
  for (int e = threadIdx.x; e < BR * VC; e += NT) {
    const int r = e / VC, c = e % VC;
    sm.x[r][c] = r < n && c0 + c < cend ? ld(src + (size_t)r * d + c0 + c) : 0.f;
  }
}

// out[i][c0 + c] = out[i][c0 + c] * keep + sum_j m[j or i] * sm.x[j][c] for
// the thread's row i = tid / 8 and columns c = tid % 8 + 8 u: m is read as
// m[i][j] (trans false: P V, dS K) or m[j][i] (trans true: P^T dO, dS^T Q).
template <bool trans>
__device__ __forceinline__ void accumulate(float* out, int ld_out, int c0, float keep,
                                           const float (*m)[LD], const Scratch& sm) {
  const int i = threadIdx.x >> 3, c = threadIdx.x & 7;
  float acc[VC / 8];
  float* row = out + (size_t)i * ld_out + c0 + c;
#pragma unroll
  for (int u = 0; u < VC / 8; ++u) acc[u] = row[8 * u] * keep;
#pragma unroll 4
  for (int j = 0; j < BR; ++j) {
    const float w = trans ? m[j][i] : m[i][j];
#pragma unroll
    for (int u = 0; u < VC / 8; ++u) acc[u] += w * sm.x[j][c + 8 * u];
  }
#pragma unroll
  for (int u = 0; u < VC / 8; ++u) row[8 * u] = acc[u];
}

// grid (ceil(nq / 32), bh, ceil(d / dout)); dynamic shared memory Scratch +
// 32 * dout floats (O).
template <typename T>
__global__ void __launch_bounds__(NT)
flash_f32_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int nq, int nk, int d,
                     int dout, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  Scratch& sm = *reinterpret_cast<Scratch*>(smem);
  float* os = reinterpret_cast<float*>(smem + sizeof(Scratch));
  const int q0 = blockIdx.x * BR, bh = blockIdx.y;
  const int cbeg = blockIdx.z * dout, cend = min(d, cbeg + dout);
  const int nqv = min(BR, nq - q0);
  const T* qp = q + ((size_t)bh * nq + q0) * d;
  const T* kp = k + (size_t)bh * nk * d;
  const T* vp = v + (size_t)bh * nk * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  for (int e = threadIdx.x; e < BR * dout; e += NT) os[e] = 0.f;
  if (threadIdx.x < BR) {
    sm.row0[threadIdx.x] = -INFINITY;
    sm.row1[threadIdx.x] = 0.f;
  }
  for (int k0 = 0; k0 < nk; k0 += BR) {
    const int nkv = min(BR, nk - k0);
    float s[2][2];
    dot_tile(qp, nqv, kp + (size_t)k0 * d, nkv, d, sm, s);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int j = tx + 16 * w;
        sm.p[ty + 16 * u][j] = j < nkv ? s[u][w] * scale_log2 : -INFINITY;
      }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BR / (NT / 32); ++r) {  // a warp a row
      const int i = warp * (BR / (NT / 32)) + r;
      const float x = sm.p[i][lane];
      const float m_old = sm.row0[i];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float pv = exp2f(x - m_new);
      const float sum = warp_sum(pv);
      sm.p[i][lane] = pv;
      if (lane == 0) {
        const float a = exp2f(m_old - m_new);
        sm.row2[i] = a;
        sm.row1[i] = sm.row1[i] * a + sum;
        sm.row0[i] = m_new;
      }
    }
    __syncthreads();
    for (int c0 = cbeg; c0 < cend; c0 += VC) {
      stage_cols(vp + (size_t)k0 * d, nkv, d, c0, cend, sm);
      __syncthreads();
      accumulate<false>(os, dout, c0 - cbeg, sm.row2[threadIdx.x >> 3], sm.p, sm);
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < BR * dout; e += NT) {
    const int i = e / dout, c = cbeg + e % dout;
    if (i < nqv && c < cend) st(o + ((size_t)bh * nq + q0 + i) * d + c, os[e] / sm.row1[i]);
  }
  if (blockIdx.z == 0 && threadIdx.x < nqv) {
    lse[(size_t)bh * nq + q0 + threadIdx.x] = sm.row0[threadIdx.x] + log2f(sm.row1[threadIdx.x]);
  }
}

// grid ceil(rows / 8), block 256: D[r] = sum_c dO[r][c] * O[r][c], a warp a
// row, lanes over c, then a fixed butterfly.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_f32_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, long long rows, int d) {
  const long long r = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += ld(o + r * d + c) * ld(dout + r * d + c);
  s = warp_sum(s);
  if (lane == 0) delta[r] = s;
}

// The scores of query rows [q0, q0 + nqv) against key rows [k0, k0 + nkv)
// of one slice: P and dS into sm.p and sm.ds as [query][key].
template <typename T>
__device__ void probs_and_grads(const T* qp, const T* kp, const T* vp, const T* dop,
                                const float* lse, const float* delta, int q0, int nqv, int k0,
                                int nkv, int d, float scale_log2, Scratch& sm) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (threadIdx.x < BR) {
    const bool ok = threadIdx.x < nqv;
    sm.row0[threadIdx.x] = ok ? lse[q0 + threadIdx.x] : 0.f;
    sm.row1[threadIdx.x] = ok ? delta[q0 + threadIdx.x] : 0.f;
  }
  float s[2][2], dp[2][2];
  dot_tile(qp + (size_t)q0 * d, nqv, kp + (size_t)k0 * d, nkv, d, sm, s);
  dot_tile(dop + (size_t)q0 * d, nqv, vp + (size_t)k0 * d, nkv, d, sm, dp);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int i = ty + 16 * u, j = tx + 16 * w;
      const float p = i < nqv && j < nkv ? exp2f(s[u][w] * scale_log2 - sm.row0[i]) : 0.f;
      sm.p[i][j] = p;
      sm.ds[i][j] = p * (dp[u][w] - sm.row1[i]);
    }
  __syncthreads();
}

// grid (ceil(nk / 32), bh, ceil(d / dout)); dynamic shared memory Scratch +
// 2 * 32 * dout floats (dK, dV). Walks every query tile in order.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_f32_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout_, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int nq, int nk, int d, int dout, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  Scratch& sm = *reinterpret_cast<Scratch*>(smem);
  float* dks = reinterpret_cast<float*>(smem + sizeof(Scratch));
  float* dvs = dks + BR * dout;
  const int k0 = blockIdx.x * BR, bh = blockIdx.y;
  const int cbeg = blockIdx.z * dout, cend = min(d, cbeg + dout);
  const int nkv = min(BR, nk - k0);
  const size_t qoff = (size_t)bh * nq * d, koff = (size_t)bh * nk * d;
  for (int e = threadIdx.x; e < 2 * BR * dout; e += NT) dks[e] = 0.f;
  for (int q0 = 0; q0 < nq; q0 += BR) {
    const int nqv = min(BR, nq - q0);
    probs_and_grads(q + qoff, k + koff, v + koff, dout_ + qoff, lse + (size_t)bh * nq,
                    delta + (size_t)bh * nq, q0, nqv, k0, nkv, d, scale_log2, sm);
    for (int c0 = cbeg; c0 < cend; c0 += VC) {
      stage_cols(dout_ + qoff + (size_t)q0 * d, nqv, d, c0, cend, sm);
      __syncthreads();
      accumulate<true>(dvs, dout, c0 - cbeg, 1.f, sm.p, sm);
      __syncthreads();
      stage_cols(q + qoff + (size_t)q0 * d, nqv, d, c0, cend, sm);
      __syncthreads();
      accumulate<true>(dks, dout, c0 - cbeg, 1.f, sm.ds, sm);
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < BR * dout; e += NT) {
    const int j = e / dout, c = cbeg + e % dout;
    if (j < nkv && c < cend) {
      st(dk + koff + (size_t)(k0 + j) * d + c, dks[e] * scale);
      st(dv + koff + (size_t)(k0 + j) * d + c, dvs[e]);
    }
  }
}

// grid (ceil(nq / 32), bh, ceil(d / dout)); dynamic shared memory Scratch +
// 32 * dout floats (dQ). Walks every key tile in order.
template <typename T>
__global__ void __launch_bounds__(NT)
flash_f32_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout_, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int nq, int nk, int d,
                    int dout, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  Scratch& sm = *reinterpret_cast<Scratch*>(smem);
  float* dqs = reinterpret_cast<float*>(smem + sizeof(Scratch));
  const int q0 = blockIdx.x * BR, bh = blockIdx.y;
  const int cbeg = blockIdx.z * dout, cend = min(d, cbeg + dout);
  const int nqv = min(BR, nq - q0);
  const size_t qoff = (size_t)bh * nq * d, koff = (size_t)bh * nk * d;
  for (int e = threadIdx.x; e < BR * dout; e += NT) dqs[e] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += BR) {
    const int nkv = min(BR, nk - k0);
    probs_and_grads(q + qoff, k + koff, v + koff, dout_ + qoff, lse + (size_t)bh * nq,
                    delta + (size_t)bh * nq, q0, nqv, k0, nkv, d, scale_log2, sm);
    for (int c0 = cbeg; c0 < cend; c0 += VC) {
      stage_cols(k + koff + (size_t)k0 * d, nkv, d, c0, cend, sm);
      __syncthreads();
      accumulate<false>(dqs, dout, c0 - cbeg, 1.f, sm.ds, sm);
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < BR * dout; e += NT) {
    const int i = e / dout, c = cbeg + e % dout;
    if (i < nqv && c < cend) st(dq + qoff + (size_t)(q0 + i) * d + c, dqs[e] * scale);
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Output columns a block holds: all of d up to the limit, else an equal
// split of d in multiples of VC.
inline int block_cols(int d, int limit) {
  const int parts = ceil_div(d, limit);
  return ceil_div(ceil_div(d, parts), VC) * VC;
}

inline size_t smem_for(int cols, int tiles) {
  return sizeof(Scratch) + (size_t)tiles * BR * cols * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int nq, int nk,
        int d, float scale, cudaStream_t stream) {
  const int cols = block_cols(d, OUT_COLS);
  const size_t smem = smem_for(cols, 1);
  cudaError_t err = allow_smem(flash_f32_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(nq, BR), bh, ceil_div(d, cols));
  flash_f32_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, nq, nk, d, cols,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* delta, void* dq, void* dk, void* dv, int bh, int nq, int nk, int d,
        float scale, cudaStream_t stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  const long long rows = (long long)bh * nq;
  flash_f32_pre_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int kv_cols = block_cols(d, OUT_COLS_KV);
  const size_t kv_smem = smem_for(kv_cols, 2);
  err = allow_smem(flash_f32_dkdv_kernel<T>, kv_smem);
  if (err != cudaSuccess) return (int)err;
  flash_f32_dkdv_kernel<T><<<dim3(ceil_div(nk, BR), bh, ceil_div(d, kv_cols)), NT, kv_smem,
                             stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, nq, nk, d, kv_cols, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int q_cols = block_cols(d, OUT_COLS);
  const size_t q_smem = smem_for(q_cols, 1);
  err = allow_smem(flash_f32_dq_kernel<T>, q_smem);
  if (err != cudaSuccess) return (int)err;
  flash_f32_dq_kernel<T><<<dim3(ceil_div(nq, BR), bh, ceil_div(d, q_cols)), NT, q_smem,
                           stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, nq, nk, d, q_cols, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output columns a block of the forward / dQ (kv 0) or dK/dV (kv 1)
// kernel holds at head dim d (ops/flash_attention.py f32_plan() holds the
// same arithmetic).
int flash_f32_cols(int d, int kv) { return block_cols(d, kv ? OUT_COLS_KV : OUT_COLS); }

// q [bh, nq, d], k and v [bh, nk, d], all contiguous, float32 (bf16 0) or
// bf16 (bf16 1) -> o [bh, nq, d] of the same type, lse [bh, nq] float32.
int flash_f32_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                  int nq, int nk, int d, float scale, int bf16, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  return bf16 ? fwd<__nv_bfloat16>(q, k, v, o, lse, bh, nq, nk, d, scale, (cudaStream_t)stream)
              : fwd<float>(q, k, v, o, lse, bh, nq, nk, d, scale, (cudaStream_t)stream);
}

// The backward: D into delta [bh, nq] float32, then dK/dV, then dQ, each of
// q's type.
int flash_f32_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv, int bh, int nq,
                  int nk, int d, float scale, int bf16, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  return bf16 ? bwd<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, nq, nk, d, scale,
                                   (cudaStream_t)stream)
              : bwd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, nq, nk, d, scale,
                           (cudaStream_t)stream);
}

}  // extern "C"
