// The fused 'simple' training augmentation (crop + colour jitter + normalise),
// hand-written for Hopper (sm_90a) CUDA cores.
//
// Replaces the TPU kernel _aug_kernel of advise_tpu/ops/pallas/fused_aug.py:57
// (launched by fused_simple_aug, advise_tpu/ops/pallas/fused_aug.py:149).
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
// The arithmetic is that of the JAX reference as XLA evaluates it on the CPU,
// inside jit as the train step runs it, where the repo's tests can hold it:
// every product and sum rounds once to float32, except where XLA contracts
// them into a fused multiply-add: the three blends, and the luma that
// crop_mean sums outside the TPU kernel (Lm). The luma of the kernel's rolls
// (L) is not contracted, and the two round apart on some pixels, white among
// them. The contrast mean is XLA's jnp.mean: the sum times the float32
// reciprocal of S^2, not a division. So this file is built with -fmad=false
// and writes each fused multiply-add it wants as __fmaf_rn and every other
// operation with a rounding intrinsic. The luma sum is an exact integer: in int32
// here, and exact in float32 (as JAX sums it) while S^2 * 255 < 2^24, that
// is S <= 256; above that the two can round apart.
//
// The TPU kernel's layout work (flat [H, W*3] rows padded to 128 lanes, the
// 8-aligned band DMA, dynamic rolls, 3-periodic lane masks) exists for
// Mosaic's DMA and lane rules and is not carried over.
//
// Bound on the card: bytes. At the SpeedPro shape (32 clips x 8 frames,
// crop 224) the window is 38.5 MB of uint8 read and 154.1 MB of float32
// (77 MB of bf16) written: about 58 us (35 us) at 3.35 TB/s, with some 15
// float operations per output element, far under the CUDA cores' rate.
//
// Design against that bound: one block per (clip, frame), so the block owns
// its contrast mean and nothing crosses blocks. The block first sums the
// window's integer luma (one warp per row, a shuffle tree, then the warps'
// sums in a fixed order), then writes the window row by row in the output's
// own [S, 3S] order: lane i of a warp writes element i of the row, so the
// stores are coalesced; it reads the three bytes of its pixel, which the
// first pass left in L1/L2. The normalisation is a 3 x 256 table per block
// (a true division for each of the 768 possible (channel, value) pairs), so
// the per-element work is the chain and one shared-memory load.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -fmad=false. The C entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int LEVELS = 256;  // uint8 values

// float32(0.299), float32(0.587), float32(0.114): the constants of the JAX
// kernel's tri(LUMA)
constexpr float LUMA_R = 0x1.322d0ep-2f;
constexpr float LUMA_G = 0x1.2c8b44p-1f;
constexpr float LUMA_B = 0x1.d2f1aap-4f;

struct Affine {  // per channel: float32(mean) * 255 and float32(std) * 255
  float m0, m1, m2, s0, s1, s2;
};

__device__ __forceinline__ float luma_of(const uint8_t* px) {
  const float r = px[0], g = px[1], b = px[2];
  return floorf(__fadd_rn(__fadd_rn(__fmul_rn(r, LUMA_R), __fmul_rn(g, LUMA_G)),
                          __fmul_rn(b, LUMA_B)));
}

__device__ __forceinline__ float mean_luma_of(const uint8_t* px) {
  const float r = px[0], g = px[1], b = px[2];
  return floorf(__fmaf_rn(b, LUMA_B, __fmaf_rn(r, LUMA_R, __fmul_rn(g, LUMA_G))));
}

__device__ __forceinline__ float clip_u8(float v) {
  return fminf(fmaxf(v, 0.f), 255.f);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
fused_aug_kernel(const uint8_t* __restrict__ clips, const int* __restrict__ tops,
                 const int* __restrict__ lefts, const float* __restrict__ bfac,
                 const float* __restrict__ cfac, const float* __restrict__ sfac,
                 const int* __restrict__ apply, const int* __restrict__ order,
                 OutT* __restrict__ out, int T, int H, int W, int S, Affine aff) {
  __shared__ float table[3 * LEVELS];
  __shared__ int warp_sums[WARPS];
  __shared__ float cmean_s;

  const int frame = blockIdx.x;  // n * T + t
  const int n = frame / T;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row_stride = (size_t)W * 3;
  const uint8_t* win =
      clips + ((size_t)frame * H + tops[n]) * row_stride + (size_t)lefts[n] * 3;

  for (int e = threadIdx.x; e < 3 * LEVELS; e += THREADS) {
    const int c = e / LEVELS;
    const float m = c == 0 ? aff.m0 : (c == 1 ? aff.m1 : aff.m2);
    const float s = c == 0 ? aff.s0 : (c == 1 ? aff.s1 : aff.s2);
    table[e] = __fdiv_rn(__fsub_rn((float)(e - c * LEVELS), m), s);
  }

  // 1. the contrast mean of the raw window
  int sum = 0;
  for (int r = warp; r < S; r += WARPS) {
    const uint8_t* row = win + (size_t)r * row_stride;
    for (int j = lane; j < S; j += 32) sum += (int)mean_luma_of(row + 3 * j);
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_sums[w];
    const float inv_area = __fdiv_rn(1.f, (float)(S * S));
    cmean_s = floorf(__fadd_rn(__fmul_rn((float)total, inv_area), 0.5f));
  }
  __syncthreads();

  // 2. the chain, element by element in the output's [S, 3S] row order
  const float cmean = cmean_s;
  const float bf = bfac[n], cf = cfac[n], sf = sfac[n];
  const bool on = apply[n] > 0;
  int ops[4];
  for (int k = 0; k < 4; ++k) ops[k] = order[4 * n + k];
  const int w3 = 3 * S;
  OutT* dst = out + (size_t)frame * S * w3;
  for (int r = warp; r < S; r += WARPS) {
    const uint8_t* row = win + (size_t)r * row_stride;
    OutT* orow = dst + (size_t)r * w3;
    for (int i = lane; i < w3; i += 32) {
      const int j = i / 3;
      const int c = i - 3 * j;
      const uint8_t* px = row + 3 * j;
      float y = px[c];
      if (on) {
        const float l = luma_of(px);
        for (int k = 0; k < 4; ++k) {
          switch (ops[k]) {
            case 0:
              y = clip_u8(floorf(__fmaf_rn(y, bf, 0.5f)));
              break;
            case 1:
              y = clip_u8(floorf(__fadd_rn(__fmaf_rn(cf, __fsub_rn(y, cmean), cmean), 0.5f)));
              break;
            case 2:
              y = clip_u8(floorf(__fadd_rn(__fmaf_rn(sf, __fsub_rn(y, l), l), 0.5f)));
              break;
            default:  // hue: the reference's jitter is a uint8 no-op
              break;
          }
        }
      }
      store(orow + i, table[c * LEVELS + (int)y]);
    }
  }
}

}  // namespace

extern "C" {

// clips [N,T,H,W,3] uint8; tops, lefts, apply int32 [N]; bfac, cfac, sfac
// float32 [N]; order int32 [N,4]; out [N,T,S,S,3] float32 (out_bf16 = 0) or
// bf16 (out_bf16 = 1). All contiguous, all on one device; the caller keeps
// top + S <= H and left + S <= W.
int fused_aug(const void* clips, const void* tops, const void* lefts, const void* bfac,
              const void* cfac, const void* sfac, const void* apply, const void* order,
              void* out, int N, int T, int H, int W, int S, float m0, float m1, float m2,
              float s0, float s1, float s2, int out_bf16, void* stream) {
  const Affine aff{m0, m1, m2, s0, s1, s2};
  const dim3 grid(N * T);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)clips;
  if (out_bf16) {
    fused_aug_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        x, (const int*)tops, (const int*)lefts, (const float*)bfac, (const float*)cfac,
        (const float*)sfac, (const int*)apply, (const int*)order, (__nv_bfloat16*)out, T, H,
        W, S, aff);
  } else {
    fused_aug_kernel<float><<<grid, THREADS, 0, st>>>(
        x, (const int*)tops, (const int*)lefts, (const float*)bfac, (const float*)cfac,
        (const float*)sfac, (const int*)apply, (const int*)order, (float*)out, T, H, W, S,
        aff);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
