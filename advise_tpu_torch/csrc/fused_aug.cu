// The fused 'simple' training augmentation (crop + colour jitter + normalise),
// hand-written for Hopper (sm_90a): a thread-block cluster per frame.
//
// Replaces the TPU kernel _aug_kernel of advise_tpu/ops/pallas/fused_aug.py:57
// (launched by fused_simple_aug, advise_tpu/ops/pallas/fused_aug.py:223).
//
// What it computes, for each (clip n, frame t) of uint8 clips [N, T, H, W, 3]:
//   x     = the S x S window at the clip's (top, left), as float;
//   L     = floor((0.299 r + 0.587 g) + 0.114 b) per pixel of x;
//   cmean = floor(sum(Lm) * fl(1 / S^2) + 0.5) over the window, where
//           Lm = floor(fma(b, 0.114, fma(r, 0.299, 0.587 g)));
//   y     = x, then per clip, in the order order[n, 0..3]:
//             0 brightness  y = clip(floor(fma(y, bf, 0.5)), 0, 255)
//             1 contrast    y = clip(floor(fma(cf, y - cmean, cmean) + 0.5), 0, 255)
//             2 saturation  y = clip(floor(fma(sf, y - L, L) + 0.5), 0, 255)
//             3 hue         the identity
//   y     = x where apply[n] == 0;
//   out   = (y - m_c) / s_c per channel c, float32 or bf16 (rounded once, to
//           nearest even), out [N, T, S, S, 3].
// The per-clip parameters are drawn outside (fused_aug.py sample_simple_aug).
//
// Bound on the card: bytes. At SpeedPro's shape (32 clips x 8 frames, crop
// 224) the window is 38.5 MB of uint8 read once and 154.1 MB of float32
// (77.1 MB of bf16) written once: 57.5 us (34.5 us) at 3.35 TB/s. The chain
// costs ~30 simple operations an output element at p = 1 (by count), which
// with bf16 output weighs about as much as the bytes.
//
// Rounding: the arithmetic is that of the JAX reference as XLA evaluates it
// on the CPU inside jit, as the train step runs it, and the output is held
// bit-equal to it and to the plain version (ops/fused_aug.py). Every product
// and sum rounds once to float32, except where XLA contracts them into a
// fused multiply-add: the three blends, and the luma that crop_mean sums
// (Lm); the chain's luma (L) is not contracted, and the two round apart on
// some pixels, white among them. So this file is built with -fmad=false and
// writes each fused multiply-add it wants as __fmaf_rn and every other
// operation with a rounding intrinsic. Further:
// - the contrast mean is XLA's jnp.mean: the sum times float32(1 / S^2),
//   not a division. The luma sum is an exact integer: int32 in each CTA and
//   across the cluster, never a float sum (JAX's float32 sum is exact too
//   while S^2 * 255 < 2^24, that is S <= 256);
// - floor(v) is 2^23 + v rounded down (__fadd_rd), minus 2^23: exact for
//   0 <= v < 2^23, and <= 0 for v < 0, which the clip takes to 0; a clip that
//   cannot bind is left out (brightness with bf >= 0 is >= 0.5; a blend with
//   factor in [0, 1] lies between y and its target, both in [0, 255]);
// - bytes become floats, and the summed lumas ints, by the same 2^23 trick;
// - the normalisation (y - m) / s is a product by float32(1 / s) and one
//   correction (Markstein's: the remainder fma(-q0, s, q) is exact, and
//   fma(r, 1 / s, q0) rounds to the true quotient). y is an integer in
//   [0, 255] there, and ops/fused_aug.py checks all 3 x 256 quotients
//   against float32 division, exactly, before a launch (a table of the 768
//   true quotients, the first design, cost more in bank-conflicted lookups).
//
// Design (ops/fused_aug.py plan() gives every number):
// - One read of each byte. A cluster of `cluster` CTAs (<= 8) takes one
//   frame, one band of `band` window rows each (28 rows x 8 at crop 224).
//   A CTA stages its band once in shared memory with 16-byte cp.async over
//   the 16-byte-aligned superset of each row: 3 * left is not aligned, and
//   each row keeps its own shift, which also covers W * 3 not a multiple
//   of 16. A chunk that would reach outside the clips tensor is read byte
//   by byte. The band is then read from shared memory twice: for the mean,
//   and for the output.
// - Why a cluster: the contrast mean needs the whole window before any
//   output. Each CTA sums its band's integer luma; the partial sums are
//   exchanged through distributed shared memory after one cluster barrier
//   (an int each, added in rank order), and each CTA then writes its band.
//   A second arrive (after the remote reads) and its wait (at the end) keep
//   each CTA's partial alive until the cluster has read it. A clip whose
//   chain is off skips the sum and the barriers (every CTA of a cluster has
//   the same clip). Two kernels would read the window twice (+38.5 MB).
// - Per-pixel work: a thread takes 4 pixels (12 bytes: 4 aligned words
//   from shared memory, funnel-shifted into place), computes each pixel's
//   luma once, runs the clip's op order over the 12 values and normalises
//   them. No divide by 3. The 6 orders of brightness, contrast and
//   saturation are compiled in, one uniform branch a group picks the
//   clip's; an order that is not a permutation runs its 4 codes as they
//   come.
// - Stores: a warp's 32 items are consecutive, so its outputs are one
//   contiguous range; each lane puts its 12 values into the warp's buffer
//   in shared memory, and the warp writes the range with contiguous
//   VW-element stores (float4 for float32, 8 bytes for bf16 when S % 4 ==
//   0; VW = 2 when S % 4 == 2, 1 for odd S, as every output row starts
//   VW-aligned; a row's last group stores 3 (S % 4) values). Each lane
//   storing its own 48 bytes left every store instruction a strided half
//   of 12 lines: with nothing else to do the kernel ran slower, not faster.
// - 40 registers a thread (the launch bound's 6 CTAs of 256 an SM): 7 CTAs
//   an SM at crop 224, against 4 at 64 registers, and faster
//   (tools/probe_fused_aug.py times both); 48 for VW 2 and 1.
// - Tried and dropped: persistent grids of clusters, one that staged the
//   next frame's band while writing the current one, and one with a ring of
//   three bands that also summed the next frame and split the cluster
//   barrier around the current frame's writes: both slower, the second at 3
//   CTAs an SM. The chain needs resident warps more than the overlap.
//
// FUSED_AUG_SKIP (a bit mask, 0 in the library) compiles parts out for
// tools/probe_fused_aug.py: 1 the luma sum and the cluster exchange, 2 the
// chain, 4 the normalisation (y is stored), 8 the staging copies;
// FUSED_AUG_MIN_BLOCKS sets the launch bound's CTAs an SM (6; 5 for VW < 4).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -fmad=false. The C entry point launches on the given
// stream and returns the launch's error (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FUSED_AUG_SKIP
#define FUSED_AUG_SKIP 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int SKIP = FUSED_AUG_SKIP;
constexpr int MAX_THREADS = 256;
#ifndef FUSED_AUG_MIN_BLOCKS
#define FUSED_AUG_MIN_BLOCKS 6
#endif
// resident CTAs of MAX_THREADS an SM that the registers must allow: 6 caps a
// thread at 40 registers, which the chain fits without a spill when S % 4 ==
// 0 (VW 4); the narrower stores of other crops take 5, 48 registers
template <int VW>
constexpr int min_blocks() {
  return VW == 4 ? FUSED_AUG_MIN_BLOCKS : FUSED_AUG_MIN_BLOCKS - 1;
}
constexpr int PIX = 4;       // pixels a thread takes at a time (12 channels)
constexpr int CHUNK = 16;    // bytes of one cp.async
constexpr float TWO23 = 8388608.f;   // 2^23: 2^23 + v holds v in its low bits
constexpr uint32_t TWO23_BITS = 0x4B000000u;

// float32(0.299), float32(0.587), float32(0.114): the constants of the JAX
// kernel's tri(LUMA)
constexpr float LUMA_R = 0x1.322d0ep-2f;
constexpr float LUMA_G = 0x1.2c8b44p-1f;
constexpr float LUMA_B = 0x1.d2f1aap-4f;

struct Affine {  // per channel: float32(mean) * 255, float32(std) * 255 and its reciprocal
  float m[3], s[3], inv[3];
};

// (y - m) / s, correctly rounded, as a product by the reciprocal and one
// correction (Markstein): q = y - m; q0 = q * inv; r = fma(-q0, s, q) (exact);
// fma(r, inv, q0). ops/fused_aug.py checks it against the true division
// for all 256 values of each channel before the launch.
__device__ __forceinline__ float normalise(float y, float m, float s, float inv) {
  const float q = __fsub_rn(y, m);
  const float q0 = __fmul_rn(q, inv);
  return __fmaf_rn(__fmaf_rn(-q0, s, q), inv, q0);
}

template <int BYTES>
struct Raw;  // a vector of BYTES bytes
template <>
struct Raw<16> { using T = uint4; };
template <>
struct Raw<8> { using T = uint2; };
template <>
struct Raw<4> { using T = uint32_t; };
template <>
struct Raw<2> { using T = uint16_t; };

// VW values from src to dst, both VW-element aligned
template <int VW, typename OutT>
__device__ __forceinline__ void copy_vec(OutT* dst, const OutT* src) {
  using V = typename Raw<VW * sizeof(OutT)>::T;
  *reinterpret_cast<V*>(dst) = *reinterpret_cast<const V*>(src);
}

// byte k of w as an exact float: the bits of 2^23 + byte, minus 2^23
__device__ __forceinline__ float byte_to_float(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, TWO23_BITS, 0x7540u | k)), TWO23);
}

// floor(v) for 0 <= v < 2^23, and a value <= 0 for v < 0: 2^23 + v rounded
// down is 2^23 + floor(v), as the floats in [2^23, 2^24) are the integers.
// Two full-rate adds where floorf is one conversion-rate FRND (1/8 the
// rate); every floor here is of a value that is >= 0 or clipped to 0.
__device__ __forceinline__ float floor_nonneg(float v) {
  return __fsub_rn(__fadd_rd(v, TWO23), TWO23);
}


// the 12 bytes at byte offset o of a staged row (any o): 4 aligned words,
// funnel-shifted by o % 4 bytes
__device__ __forceinline__ void load_group(const uint8_t* row, uint32_t o, float x[3 * PIX]) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row + (o & ~3u));
  const uint32_t a = p[0], b = p[1], c = p[2], d = p[3];
  const uint32_t sh = (o & 3u) * 8u;
  const uint32_t w[3] = {__funnelshift_r(a, b, sh), __funnelshift_r(b, c, sh),
                         __funnelshift_r(c, d, sh)};
#pragma unroll
  for (int i = 0; i < 3 * PIX; ++i) x[i] = byte_to_float(w[i / 4], i % 4);
}

__device__ __forceinline__ float luma_of(const float* px) {
  return floor_nonneg(__fadd_rn(__fadd_rn(__fmul_rn(px[0], LUMA_R), __fmul_rn(px[1], LUMA_G)),
                                __fmul_rn(px[2], LUMA_B)));
}

// the bits of 2^23 + Lm, Lm = floor(fma(b, 0.114, fma(r, 0.299, 0.587 g))) >= 0:
// the luma sum adds them less 2^23's bits, an exact integer
__device__ __forceinline__ uint32_t mean_luma_bits(const float* px) {
  return __float_as_uint(
      __fadd_rd(__fmaf_rn(px[2], LUMA_B, __fmaf_rn(px[0], LUMA_R, __fmul_rn(px[1], LUMA_G))), TWO23));
}

// VW values from v to p (VW-element aligned), rounded to OutT
template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VW == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (VW == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// brightness: floor(fma(y, f, 0.5)) clipped to [0, 255], for 12 values y;
// with f >= 0 the value is >= 0.5 and only the top clip can bind
template <bool CLIP_LOW>
__device__ __forceinline__ void brighten(float y[3 * PIX], float f) {
#pragma unroll
  for (int j = 0; j < 3 * PIX; ++j) {
    const float v = floor_nonneg(__fmaf_rn(y[j], f, 0.5f));
    y[j] = fminf(CLIP_LOW ? fmaxf(v, 0.f) : v, 255.f);
  }
}

// blend: floor(fma(f, y - c, c) + 0.5) clipped to [0, 255], for 12 values y
// towards c (the contrast mean, or each pixel's luma); with f in [0, 1] the
// value lies between y and c, in [0, 255], and no clip can bind
template <bool CLIP>
__device__ __forceinline__ void blend(float y[3 * PIX], float f, const float* c, int c_step) {
#pragma unroll
  for (int j = 0; j < 3 * PIX; ++j) {
    const float cj = c[c_step * (j / 3)];
    const float v = floor_nonneg(__fadd_rn(__fmaf_rn(f, __fsub_rn(y[j], cj), cj), 0.5f));
    y[j] = CLIP ? fminf(fmaxf(v, 0.f), 255.f) : v;
  }
}

// a clip's factors, its frame's contrast mean, and which clips can bind
struct Jitter {
  float bf, cf, sf, cmean;
  bool bclip, cclip, sclip;
};

// op OP of the chain on a group's 12 values y (l: the 4 pixels' lumas)
template <int OP>
__device__ __forceinline__ void chain_op(float y[3 * PIX], const float l[PIX], const Jitter& j) {
  if constexpr (OP == 0) {
    if (j.bclip) brighten<true>(y, j.bf);
    else brighten<false>(y, j.bf);
  } else if constexpr (OP == 1) {
    if (j.cclip) blend<true>(y, j.cf, &j.cmean, 0);
    else blend<false>(y, j.cf, &j.cmean, 0);
  } else if constexpr (OP == 2) {
    if (j.sclip) blend<true>(y, j.sf, l, 1);
    else blend<false>(y, j.sf, l, 1);
  }  // 3, hue: the reference's jitter is a uint8 no-op
}

// a step of the chain: op V, known when the kernel is compiled, or byte K of
// a word of the clip's 4 codes, known only when it runs (one register for
// all four)
template <int V>
struct Op {};
template <int K>
struct CodeAt {
  uint32_t word;
};
template <int V>
__device__ __forceinline__ void chain_step(Op<V>, float y[3 * PIX], const float l[PIX],
                                           const Jitter& j) {
  chain_op<V>(y, l, j);
}
template <int K>
__device__ __forceinline__ void chain_step(CodeAt<K> c, float y[3 * PIX], const float l[PIX],
                                           const Jitter& j) {
  switch ((c.word >> (8 * K)) & 0xffu) {
    case 0: chain_op<0>(y, l, j); break;
    case 1: chain_op<1>(y, l, j); break;
    case 2: chain_op<2>(y, l, j); break;
    default: break;
  }
}

// three steps of the chain
template <typename A, typename B, typename C>
__device__ __forceinline__ void chain3(A a, B b, C c, float y[3 * PIX], const float l[PIX],
                                       const Jitter& j) {
  chain_step(a, y, l, j);
  chain_step(b, y, l, j);
  chain_step(c, y, l, j);
}

// One CTA: band `rank` (window rows [rank * band, ...)) of frame
// blockIdx.x / cluster. Dynamic shared memory: the band, `pitch` bytes a row.
template <int VW, typename OutT>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks<VW>())
fused_aug_kernel(const uint8_t* __restrict__ clips, size_t clip_bytes,
                 const int* __restrict__ tops, const int* __restrict__ lefts,
                 const float* __restrict__ bfac, const float* __restrict__ cfac,
                 const float* __restrict__ sfac, const int* __restrict__ apply,
                 const int* __restrict__ order, OutT* __restrict__ out, int T, int H, int W,
                 int S, int band, int pitch, Affine aff) {
  extern __shared__ __align__(16) uint8_t band_s[];
  __shared__ __align__(16) uint8_t out_s[MAX_THREADS / 32][32 * 3 * PIX * sizeof(OutT)];
  __shared__ int warp_sums[MAX_THREADS / 32];
  __shared__ int partial;
  __shared__ float cmean_s;

  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int frame = blockIdx.x / ranks;  // n * T + t
  const int n = frame / T;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid % 32;
  const int r0 = rank * band;
  const int rows = min(band, S - r0);
  const int w3 = 3 * S;
  const size_t row_stride = (size_t)W * 3;
  const uint8_t* win =
      clips + ((size_t)frame * H + tops[n] + r0) * row_stride + (size_t)lefts[n] * 3;
  const bool on = apply[n] > 0;

  // 1. stage the band: chunk k of row r is the 16 aligned bytes at
  //    align_down(row start) + 16 k; a row's bytes sit at its shift
  if (!(SKIP & 8)) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(clips), hi = lo + clip_bytes;
    const int max_chunks = (w3 + 2 * CHUNK - 2) / CHUNK;  // (3S + 15) / 16 rounded up
    for (int i = tid; i < rows * max_chunks; i += nth) {
      const int r = i / max_chunks;
      const int k = i - r * max_chunks;
      const uintptr_t start = reinterpret_cast<uintptr_t>(win + (size_t)r * row_stride);
      const uintptr_t g = (start & ~(uintptr_t)(CHUNK - 1)) + (uintptr_t)k * CHUNK;
      if (g >= start + w3) continue;  // past this row's window
      uint8_t* dst = band_s + (size_t)r * pitch + k * CHUNK;
      if (g >= lo && g + CHUNK <= hi) {
        cp_async16(dst, reinterpret_cast<const void*>(g));
      } else {  // the tensor's first or last bytes
        for (int b = 0; b < CHUNK; ++b)
          if (g + b >= lo && g + b < hi) dst[b] = *reinterpret_cast<const uint8_t*>(g + b);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  // work items (row, group of 4 pixels), walked with fixed strides
  const int groups = (S + PIX - 1) / PIX;
  const int dr = nth / groups, dg = nth - (nth / groups) * groups;
  const int r_first = tid / groups, g_first = tid - (tid / groups) * groups;
  auto shift_of = [&](int r) {
    return (uint32_t)(reinterpret_cast<uintptr_t>(win + (size_t)r * row_stride) & (CHUNK - 1));
  };

  // 2. the contrast mean: this band's integer luma sum, then the cluster's,
  //    in rank order, through distributed shared memory
  float cmean = 128.f;
  if (on && !(SKIP & 1)) {
    int sum = 0;
    for (int r = r_first, g = g_first; r < rows;) {
      float x[3 * PIX];
      load_group(band_s + (size_t)r * pitch, shift_of(r) + 12u * g, x);
#pragma unroll
      for (int p = 0; p < PIX; ++p)
        if (g * PIX + p < S) sum += (int)(mean_luma_bits(x + 3 * p) - TWO23_BITS);
      g += dg;
      r += dr;
      if (g >= groups) {
        g -= groups;
        ++r;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) warp_sums[tid / 32] = sum;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < nth / 32; ++w) total += warp_sums[w];
      partial = total;
    }
    cluster.sync();  // every CTA's partial is written
    if (tid < 32) {  // lane k reads CTA k's partial; lane 0 adds them in rank order
      const int part = lane < ranks ? *cluster.map_shared_rank(&partial, lane) : 0;
      int total = 0;
      for (int k = 0; k < ranks; ++k) total += __shfl_sync(0xffffffffu, part, k);
      const float inv_area = __fdiv_rn(1.f, (float)(S * S));
      if (lane == 0) cmean_s = floor_nonneg(__fadd_rn(__fmul_rn((float)total, inv_area), 0.5f));
    }
    cluster_arrive();  // this CTA has read the others' partials
    __syncthreads();
    cmean = cmean_s;
  }

  // 3. the chain over each group and the normalised output. The clip's
  //    order is one of the 6 orders of the three ops that change y, each a
  //    chain compiled in, chosen by one uniform branch a group (an order
  //    that is not a permutation runs its 4 codes as they come). A warp's
  //    32 items are consecutive, so its outputs are one contiguous range of
  //    the band's output: each lane puts its values into the warp's buffer,
  //    and the warp writes the range with contiguous VW-element stores.
  Jitter jit;
  jit.bf = bfac[n];
  jit.cf = cfac[n];
  jit.sf = sfac[n];
  jit.cmean = cmean;
  jit.bclip = !(jit.bf >= 0.f);
  jit.cclip = !(jit.cf >= 0.f && jit.cf <= 1.f);
  jit.sclip = !(jit.sf >= 0.f && jit.sf <= 1.f);
  uint32_t codes = 0;          // the 4 codes, a byte each (3 for any that is not 0, 1, 2)
  uint32_t seq = 0, seen = 0;  // the non-hue codes in order, 2 bits each
  int kept = 0;
  for (int k = 0; k < 4; ++k) {
    const int c = order[4 * n + k];
    const uint32_t op = c >= 0 && c < 3 ? (uint32_t)c : 3u;
    codes |= op << (8 * k);
    if (op < 3) {
      seq |= op << (2 * kept++);
      seen |= 1u << op;
    }
  }
  int chain = 6;  // the orders, as seq: 0 1 2 | 0 2 1 | 1 0 2 | 1 2 0 | 2 0 1 | 2 1 0
  if (kept == 3 && seen == 7) {
    switch (seq) {
      case 0 | 1 << 2 | 2 << 4: chain = 0; break;
      case 0 | 2 << 2 | 1 << 4: chain = 1; break;
      case 1 | 0 << 2 | 2 << 4: chain = 2; break;
      case 1 | 2 << 2 | 0 << 4: chain = 3; break;
      case 2 | 0 << 2 | 1 << 4: chain = 4; break;
      default: chain = 5; break;
    }
  }
  OutT* dst = out + ((size_t)frame * S + r0) * w3;
  OutT* buf = reinterpret_cast<OutT*>(out_s[tid / 32]);  // the warp's outputs
  for (int r = r_first, g = g_first;;) {
    const bool active = r < rows;
    const unsigned act = __ballot_sync(0xffffffffu, active);
    if (act == 0) break;
    int pos = 0, values = 0;  // this item's place in the band's output, and its values
    float y[3 * PIX];
    if (active) {
      load_group(band_s + (size_t)r * pitch, shift_of(r) + 12u * g, y);
      if (on && !(SKIP & 2)) {
        float l[PIX];
#pragma unroll
        for (int p = 0; p < PIX; ++p) l[p] = luma_of(y + 3 * p);
        switch (chain) {
          case 0: chain3(Op<0>{}, Op<1>{}, Op<2>{}, y, l, jit); break;
          case 1: chain3(Op<0>{}, Op<2>{}, Op<1>{}, y, l, jit); break;
          case 2: chain3(Op<1>{}, Op<0>{}, Op<2>{}, y, l, jit); break;
          case 3: chain3(Op<1>{}, Op<2>{}, Op<0>{}, y, l, jit); break;
          case 4: chain3(Op<2>{}, Op<0>{}, Op<1>{}, y, l, jit); break;
          case 5: chain3(Op<2>{}, Op<1>{}, Op<0>{}, y, l, jit); break;
          default:
            chain3(CodeAt<0>{codes}, CodeAt<1>{codes}, CodeAt<2>{codes}, y, l, jit);
            chain_step(CodeAt<3>{codes}, y, l, jit);
            break;
        }
      }
      if (!(SKIP & 4)) {
#pragma unroll
        for (int j = 0; j < 3 * PIX; ++j)
          y[j] = normalise(y[j], aff.m[j % 3], aff.s[j % 3], aff.inv[j % 3]);
      }
      pos = r * w3 + 12 * g;
      values = 3 * min(PIX, S - g * PIX);  // a multiple of VW
      g += dg;
      r += dr;
      if (g >= groups) {
        g -= groups;
        ++r;
      }
    }
    // the active lanes are a prefix of the warp, lane 0 the first item
    const int first = __shfl_sync(0xffffffffu, pos, 0);
    const int end = __shfl_sync(0xffffffffu, pos + values, 31 - __clz(act));
    if (active) {
      OutT* b = buf + (pos - first);
#pragma unroll
      for (int j = 0; j < 3 * PIX / VW; ++j)
        if (j * VW < values) store_vec<VW>(b + j * VW, y + j * VW);
    }
    __syncwarp();
#pragma unroll
    for (int e = lane * VW; e < 32 * 3 * PIX; e += 32 * VW)
      if (e < end - first) copy_vec<VW>(dst + first + e, buf + e);
    __syncwarp();
  }
  if (on && !(SKIP & 1)) cluster_wait();  // the others have read this CTA's partial
}

template <int VW, typename OutT>
cudaError_t launch(const uint8_t* clips, size_t clip_bytes, const int* tops, const int* lefts,
                   const float* bfac, const float* cfac, const float* sfac, const int* apply,
                   const int* order, OutT* out, int frames, int T, int H, int W, int S,
                   int cluster, int band, int threads, int pitch, int smem, Affine aff,
                   cudaStream_t stream) {
  auto kernel = fused_aug_kernel<VW, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * frames);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, clips, clip_bytes, tops, lefts, bfac, cfac, sfac, apply,
                           order, out, T, H, W, S, band, pitch, aff);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_vw(int vw, const uint8_t* clips, size_t clip_bytes, const int* tops,
                      const int* lefts, const float* bfac, const float* cfac, const float* sfac,
                      const int* apply, const int* order, OutT* out, int frames, int T, int H,
                      int W, int S, int cluster, int band, int threads, int pitch, int smem,
                      Affine aff, cudaStream_t stream) {
  switch (vw) {
    case 4:
      return launch<4>(clips, clip_bytes, tops, lefts, bfac, cfac, sfac, apply, order, out,
                       frames, T, H, W, S, cluster, band, threads, pitch, smem, aff, stream);
    case 2:
      return launch<2>(clips, clip_bytes, tops, lefts, bfac, cfac, sfac, apply, order, out,
                       frames, T, H, W, S, cluster, band, threads, pitch, smem, aff, stream);
    case 1:
      return launch<1>(clips, clip_bytes, tops, lefts, bfac, cfac, sfac, apply, order, out,
                       frames, T, H, W, S, cluster, band, threads, pitch, smem, aff, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// clips [N,T,H,W,3] uint8; tops, lefts, apply int32 [N]; bfac, cfac, sfac
// float32 [N]; order int32 [N,4]; out [N,T,S,S,3] float32 (out_bf16 = 0) or
// bf16 (out_bf16 = 1). All contiguous, all on one device; the caller keeps
// top + S <= H and left + S <= W. m, s: float32(mean) * 255 and float32(std)
// * 255 per channel, i: float32(1 / s), for which normalise() is exact (the
// caller checks). cluster, band, threads, pitch, smem (the band's dynamic
// shared bytes) and vw come from ops/fused_aug.py plan(): S % vw == 0,
// threads a multiple of 32 up to 256, pitch a multiple of 16 of at least
// 3 S + 30, band rows a CTA and cluster = ceil(S / band) <= 8.
int fused_aug(const void* clips, const void* tops, const void* lefts, const void* bfac,
              const void* cfac, const void* sfac, const void* apply, const void* order,
              void* out, int N, int T, int H, int W, int S, int cluster, int band, int threads,
              int pitch, int smem, int vw, float m0, float m1, float m2, float s0, float s1,
              float s2, float i0, float i1, float i2, int out_bf16, void* stream) {
  if (S % vw != 0 || threads % 32 != 0 || threads > MAX_THREADS || pitch % CHUNK != 0 ||
      pitch < 3 * S + 2 * CHUNK - 2 || (cluster - 1) * band >= S || cluster * band < S ||
      smem < band * pitch)
    return (int)cudaErrorInvalidValue;
  const Affine aff{{m0, m1, m2}, {s0, s1, s2}, {i0, i1, i2}};
  const size_t clip_bytes = (size_t)N * T * H * W * 3;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)clips;
  const int *tp = (const int*)tops, *lf = (const int*)lefts, *ap = (const int*)apply,
            *od = (const int*)order;
  const float *bf = (const float*)bfac, *cf = (const float*)cfac, *sf = (const float*)sfac;
  const cudaError_t err =
      out_bf16 ? launch_vw(vw, x, clip_bytes, tp, lf, bf, cf, sf, ap, od, (__nv_bfloat16*)out,
                           N * T, T, H, W, S, cluster, band, threads, pitch, smem, aff, st)
               : launch_vw(vw, x, clip_bytes, tp, lf, bf, cf, sf, ap, od, (float*)out, N * T, T,
                           H, W, S, cluster, band, threads, pitch, smem, aff, st);
  return (int)err;
}

}  // extern "C"
