// SyncBatchNorm's train mode (advise_tpu_torch/models/layers/norm.py),
// hand-written for Hopper (sm_90a) CUDA cores: the statistics, the fold and
// the backward, each one pass over the activation.
//
// Replaces no TPU kernel. The JAX package's SyncBatchNorm
// (advise_tpu/models/layers/norm.py) is a chain of jnp operations that XLA
// fuses into one reduction and one elementwise pass; eager PyTorch ran the
// same chain as ~16 launches forward and ~25 backward a BN, with a float32
// copy of the activation saved for the backward.
//
// What it computes, for x [rows, C] with C innermost in memory (the models'
// channels-last NDHWC activations, the heads' [B, C]), its rows in `splits`
// contiguous ranges of n = rows / splits (one per batch slice: views x
// BN.NUM_SPLITS), T the type of x (bf16 or float32):
//   stats       mean[s, c] = sum x / n, meansq[s, c] = sum x^2 / n, float32;
//   apply       var = meansq - mean^2, r = 1 / sqrt(var + eps), w = scale * r,
//               b = -mean * w + bias, each operation rounded once to float32
//               (the plain version's order); y = x * T(w) + T(b), computed in
//               float32 from w and b rounded to T, rounded once to T;
//   grad stats  per (s, c) the sums of g and g * xh, xh = (x - mean) * r:
//               their means over n, and their totals over the splits (the
//               bias's and the scale's gradients);
//   dx          dx = scale * r * (g - mean_g - xh * mean_gxh), rounded once
//               to T.
// Between stats and apply, and between grad stats and dx, the wrapper may
// average the [2, splits, C] means over a sync group (the Function of
// models/layers/norm.py). The rounding of w and b to T is the identity in
// the backward, as autograd treats the cast.
//
// Bound on the card: bytes. One read of x for the statistics, one read and
// one write for the fold (6 B an element in bf16), one read of g and x for
// the sums and one more with a write for dx (10 B). Design:
// - 16-byte vectors over C (8 bf16, 4 float32; narrower where C or a
//   pointer is not aligned to 16 bytes: ops/batch_norm.py plan() picks the
//   width), a block of up to 256 threads over a channel tile x a few rows,
//   so a warp reads a contiguous range, and 4 rows a thread in flight;
// - about 4 blocks an SM (528 on 132 SMs) each over one contiguous range of
//   rows of one split, so the stem's [3.2 M, 64] and the heads' [32, 4096]
//   both fill the card: many row blocks for few channels, wide channel
//   tiles for few rows;
// - the sums: each thread in float32 over its rows in order, the block's
//   threads of one channel in a fixed tree in shared memory, the blocks'
//   partials in a second small kernel in float64 in block order. No float
//   atomics: a run repeats bit for bit, so REMAT's recompute of a forward
//   gives what the first forward gave;
// - the [C]-sized fold (rsqrt, w, b) runs per thread in the apply and dx
//   kernels from the statistics, so nothing but the two passes and the
//   combine touches the card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. Each C entry point launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_VEC = 8;   // elements a thread loads at once: 16 bytes of bf16
constexpr int UNROLL = 4;    // rows a thread has in flight
constexpr int COMBINE_X = 32, COMBINE_Y = 16;  // the combine's block: channels x partial lanes

// how ops/batch_norm.py plan() runs a shape
struct Geom {
  long long rows_split;  // n, the rows of a split
  long long rpb;         // rows a block
  int c, splits;
  int ct;                // vectors of a channel tile (threads a row)
  int ctiles;
  int rpi;               // rows a block reads at once (threads = ct * rpi)
  int nb;                // row blocks a split
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 1 / sqrt(meansq - mean^2 + eps), each operation rounded once
__device__ __forceinline__ float rstd_of(float mean, float meansq, float eps) {
  const float var = __fsub_rn(meansq, __fmul_rn(mean, mean));
  return __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
}

// The thread's place: `lane` its vector within the channel tile, `slot` its
// row among the block's rpi, `vi` its vector of the row; rows [r0, r1).
struct Place {
  int lane, slot, vi, split;
  long long r0, r1;
  bool on;
};

__device__ __forceinline__ Place place(const Geom& g, int vec) {
  Place p;
  p.lane = threadIdx.x % g.ct;
  p.slot = threadIdx.x / g.ct;
  p.vi = blockIdx.y * g.ct + p.lane;
  p.split = blockIdx.z;
  const long long start = static_cast<long long>(p.split) * g.rows_split;
  p.r0 = start + static_cast<long long>(blockIdx.x) * g.rpb;
  p.r1 = min(p.r0 + g.rpb, start + g.rows_split);
  p.on = p.vi * vec < g.c;
  return p;
}

// a[k] and b[k] summed over the block's rpi row slots in a fixed tree
// order; the sums land in slot 0's threads. Every thread of the block calls it.
template <int V>
__device__ __forceinline__ void block_sum(float (&a)[V], float (&b)[V], const Geom& g, const Place& p) {
  __shared__ float sh[2 * MAX_VEC * MAX_THREADS];
  const int span = g.ct * g.rpi;  // floats of one k plane: [k][slot][lane]
  const int me = p.slot * g.ct + p.lane;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sh[k * span + me] = a[k];
    sh[(V + k) * span + me] = b[k];
  }
  __syncthreads();
  int top = 1;
  while (top < g.rpi) top <<= 1;
  for (int h = top >> 1; h > 0; h >>= 1) {
    if (p.slot < h && p.slot + h < g.rpi) {
      const int other = me + h * g.ct;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] += sh[k * span + other];
        b[k] += sh[(V + k) * span + other];
        sh[k * span + me] = a[k];
        sh[(V + k) * span + me] = b[k];
      }
    }
    __syncthreads();
  }
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* base, long long row, int c) {
  return *reinterpret_cast<const Pack<T, V>*>(base + row * c);
}

// the float32 partial sums of x and x^2 of each (split, row block, channel):
// part [splits][nb][2][C]
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) stats_kernel(const T* __restrict__ x,
                                                            float* __restrict__ part, Geom g) {
  const Place p = place(g, V);
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (p.on) {
    const T* base = x + p.vi * V;
    long long r = p.r0 + p.slot;
    for (; r + (UNROLL - 1) * g.rpi < p.r1; r += UNROLL * g.rpi) {
      Pack<T, V> u[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) u[i] = load<T, V>(base, r + i * g.rpi, g.c);
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = to_f(u[i].v[k]);
          s[k] += f;
          q[k] = fmaf(f, f, q[k]);
        }
      }
    }
    for (; r < p.r1; r += g.rpi) {
      const Pack<T, V> u = load<T, V>(base, r, g.c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f(u.v[k]);
        s[k] += f;
        q[k] = fmaf(f, f, q[k]);
      }
    }
  }
  block_sum<V>(s, q, g, p);
  if (p.slot == 0 && p.on) {
    float* out = part + (static_cast<long long>(p.split) * g.nb + blockIdx.x) * 2 * g.c + p.vi * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = s[k];
      out[g.c + k] = q[k];
    }
  }
}

// per (split, channel) the nb partials of part [splits][nb][2][C] summed in
// float64 in block order (COMBINE_Y lanes, then a fixed tree), over n:
// out [2][splits][C]; with totals, each sum's total over the splits: [2][C]
__global__ void __launch_bounds__(COMBINE_X* COMBINE_Y)
    combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                   float* __restrict__ totals, Geom g) {
  __shared__ double sh[2][COMBINE_Y][COMBINE_X];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * COMBINE_X + tx;
  const double n = static_cast<double>(g.rows_split);
  double ta = 0.0, tb = 0.0;
  for (int s = 0; s < g.splits; ++s) {
    double a = 0.0, b = 0.0;
    if (ch < g.c) {
      for (int j = ty; j < g.nb; j += COMBINE_Y) {
        const float* p = part + (static_cast<long long>(s) * g.nb + j) * 2 * g.c + ch;
        a += p[0];
        b += p[g.c];
      }
    }
    sh[0][ty][tx] = a;
    sh[1][ty][tx] = b;
    __syncthreads();
    for (int h = COMBINE_Y / 2; h > 0; h >>= 1) {
      if (ty < h) {
        sh[0][ty][tx] += sh[0][ty + h][tx];
        sh[1][ty][tx] += sh[1][ty + h][tx];
      }
      __syncthreads();
    }
    if (ty == 0 && ch < g.c) {
      a = sh[0][0][tx];
      b = sh[1][0][tx];
      out[static_cast<long long>(s) * g.c + ch] = static_cast<float>(a / n);
      out[static_cast<long long>(g.splits + s) * g.c + ch] = static_cast<float>(b / n);
      ta += a;
      tb += b;
    }
    __syncthreads();
  }
  if (totals != nullptr && ty == 0 && ch < g.c) {
    totals[ch] = static_cast<float>(ta);
    totals[g.c + ch] = static_cast<float>(tb);
  }
}

// y = x * T(w) + T(b) per (split, channel), stats [2][splits][C]
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ stats,
                 const float* __restrict__ scale, const float* __restrict__ bias, float eps, Geom g) {
  const Place p = place(g, V);
  if (!p.on) return;
  float w[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = p.vi * V + k;
    const float mean = stats[static_cast<long long>(p.split) * g.c + ch];
    const float meansq = stats[static_cast<long long>(g.splits + p.split) * g.c + ch];
    const float wf = __fmul_rn(rstd_of(mean, meansq, eps), scale[ch]);
    const float bf = __fadd_rn(__fmul_rn(-mean, wf), bias[ch]);
    w[k] = to_f(from_f<T>(wf));
    b[k] = to_f(from_f<T>(bf));
  }
  const T* xb = x + p.vi * V;
  T* yb = y + p.vi * V;
  long long r = p.r0 + p.slot;
  for (; r + (UNROLL - 1) * g.rpi < p.r1; r += UNROLL * g.rpi) {
    Pack<T, V> u[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) u[i] = load<T, V>(xb, r + i * g.rpi, g.c);
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      Pack<T, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k) o.v[k] = from_f<T>(__fadd_rn(__fmul_rn(to_f(u[i].v[k]), w[k]), b[k]));
      *reinterpret_cast<Pack<T, V>*>(yb + (r + i * g.rpi) * g.c) = o;
    }
  }
  for (; r < p.r1; r += g.rpi) {
    const Pack<T, V> u = load<T, V>(xb, r, g.c);
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.v[k] = from_f<T>(__fadd_rn(__fmul_rn(to_f(u.v[k]), w[k]), b[k]));
    *reinterpret_cast<Pack<T, V>*>(yb + r * g.c) = o;
  }
}

// the partial sums of g and g * xh of each (split, row block, channel)
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    grad_stats_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                      const float* __restrict__ stats, float eps, float* __restrict__ part, Geom g) {
  const Place p = place(g, V);
  float sg[V], sgx[V], mean[V], r[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sg[k] = sgx[k] = 0.f;
  if (p.on) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ch = p.vi * V + k;
      mean[k] = stats[static_cast<long long>(p.split) * g.c + ch];
      r[k] = rstd_of(mean[k], stats[static_cast<long long>(g.splits + p.split) * g.c + ch], eps);
    }
    const T* gb = gy + p.vi * V;
    const T* xb = x + p.vi * V;
    long long row = p.r0 + p.slot;
    for (; row + (UNROLL - 1) * g.rpi < p.r1; row += UNROLL * g.rpi) {
      Pack<T, V> ug[UNROLL], ux[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        ug[i] = load<T, V>(gb, row + i * g.rpi, g.c);
        ux[i] = load<T, V>(xb, row + i * g.rpi, g.c);
      }
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float gf = to_f(ug[i].v[k]);
          const float xh = __fmul_rn(__fsub_rn(to_f(ux[i].v[k]), mean[k]), r[k]);
          sg[k] += gf;
          sgx[k] = fmaf(gf, xh, sgx[k]);
        }
      }
    }
    for (; row < p.r1; row += g.rpi) {
      const Pack<T, V> ug = load<T, V>(gb, row, g.c);
      const Pack<T, V> ux = load<T, V>(xb, row, g.c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float gf = to_f(ug.v[k]);
        const float xh = __fmul_rn(__fsub_rn(to_f(ux.v[k]), mean[k]), r[k]);
        sg[k] += gf;
        sgx[k] = fmaf(gf, xh, sgx[k]);
      }
    }
  }
  block_sum<V>(sg, sgx, g, p);
  if (p.slot == 0 && p.on) {
    float* out = part + (static_cast<long long>(p.split) * g.nb + blockIdx.x) * 2 * g.c + p.vi * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = sg[k];
      out[g.c + k] = sgx[k];
    }
  }
}

// dx = scale * r * (g - mean_g - xh * mean_gxh), means [2][splits][C]
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    dx_kernel(const T* __restrict__ gy, const T* __restrict__ x, const float* __restrict__ stats,
              const float* __restrict__ means, const float* __restrict__ scale, float eps,
              T* __restrict__ dx, Geom g) {
  const Place p = place(g, V);
  if (!p.on) return;
  float mean[V], r[V], ks[V], mg[V], mgx[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = p.vi * V + k;
    const long long lo = static_cast<long long>(p.split) * g.c + ch;
    const long long hi = static_cast<long long>(g.splits + p.split) * g.c + ch;
    mean[k] = stats[lo];
    r[k] = rstd_of(mean[k], stats[hi], eps);
    ks[k] = __fmul_rn(scale[ch], r[k]);
    mg[k] = means[lo];
    mgx[k] = means[hi];
  }
  const T* gb = gy + p.vi * V;
  const T* xb = x + p.vi * V;
  T* db = dx + p.vi * V;
  long long row = p.r0 + p.slot;
  for (; row + (UNROLL - 1) * g.rpi < p.r1; row += UNROLL * g.rpi) {
    Pack<T, V> ug[UNROLL], ux[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      ug[i] = load<T, V>(gb, row + i * g.rpi, g.c);
      ux[i] = load<T, V>(xb, row + i * g.rpi, g.c);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      Pack<T, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = __fmul_rn(__fsub_rn(to_f(ux[i].v[k]), mean[k]), r[k]);
        const float d = __fsub_rn(__fsub_rn(to_f(ug[i].v[k]), mg[k]), __fmul_rn(xh, mgx[k]));
        o.v[k] = from_f<T>(__fmul_rn(ks[k], d));
      }
      *reinterpret_cast<Pack<T, V>*>(db + (row + i * g.rpi) * g.c) = o;
    }
  }
  for (; row < p.r1; row += g.rpi) {
    const Pack<T, V> ug = load<T, V>(gb, row, g.c);
    const Pack<T, V> ux = load<T, V>(xb, row, g.c);
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = __fmul_rn(__fsub_rn(to_f(ux.v[k]), mean[k]), r[k]);
      const float d = __fsub_rn(__fsub_rn(to_f(ug.v[k]), mg[k]), __fmul_rn(xh, mgx[k]));
      o.v[k] = from_f<T>(__fmul_rn(ks[k], d));
    }
    *reinterpret_cast<Pack<T, V>*>(db + row * g.c) = o;
  }
}

dim3 grid_of(const Geom& g) {
  return dim3(static_cast<unsigned>(g.nb), static_cast<unsigned>(g.ctiles),
              static_cast<unsigned>(g.splits));
}

dim3 combine_grid(const Geom& g) { return dim3(static_cast<unsigned>((g.c + COMBINE_X - 1) / COMBINE_X)); }

template <typename T, int V>
cudaError_t run_stats(const void* x, float* part, float* stats, const Geom& g, cudaStream_t st) {
  stats_kernel<T, V><<<grid_of(g), g.ct * g.rpi, 0, st>>>(static_cast<const T*>(x), part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<combine_grid(g), dim3(COMBINE_X, COMBINE_Y), 0, st>>>(part, stats, nullptr, g);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_apply(const void* x, void* y, const float* stats, const float* scale,
                      const float* bias, float eps, const Geom& g, cudaStream_t st) {
  apply_kernel<T, V><<<grid_of(g), g.ct * g.rpi, 0, st>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                          stats, scale, bias, eps, g);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_grad_stats(const void* gy, const void* x, const float* stats, float eps, float* part,
                           float* means, float* totals, const Geom& g, cudaStream_t st) {
  grad_stats_kernel<T, V><<<grid_of(g), g.ct * g.rpi, 0, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(x), stats, eps, part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<combine_grid(g), dim3(COMBINE_X, COMBINE_Y), 0, st>>>(part, means, totals, g);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_dx(const void* gy, const void* x, const float* stats, const float* means,
                   const float* scale, float eps, void* dx, const Geom& g, cudaStream_t st) {
  dx_kernel<T, V><<<grid_of(g), g.ct * g.rpi, 0, st>>>(static_cast<const T*>(gy), static_cast<const T*>(x),
                                                       stats, means, scale, eps, static_cast<T*>(dx), g);
  return cudaGetLastError();
}

// fn<T, V> for x's type (bf16 or float32) and the vector width, or nullptr
#define PICK(fn, bf16, vec)                                                                     \
  ((bf16) ? ((vec) == 8   ? &fn<__nv_bfloat16, 8>                                               \
             : (vec) == 4 ? &fn<__nv_bfloat16, 4>                                               \
             : (vec) == 2 ? &fn<__nv_bfloat16, 2>                                               \
             : (vec) == 1 ? &fn<__nv_bfloat16, 1>                                               \
                          : nullptr)                                                            \
          : ((vec) == 4 ? &fn<float, 4> : (vec) == 2 ? &fn<float, 2> : (vec) == 1 ? &fn<float, 1> \
                                                                                   : nullptr))

Geom geom(long long rows_split, long long rpb, int c, int splits, int ct, int ctiles, int rpi, int nb) {
  return Geom{rows_split, rpb, c, splits, ct, ctiles, rpi, nb};
}

bool valid(const Geom& g, int vec) {
  return g.rows_split > 0 && g.rpb > 0 && g.c > 0 && g.splits > 0 && g.ct > 0 && g.rpi > 0 &&
         g.ct * g.rpi <= MAX_THREADS && vec >= 1 && vec <= MAX_VEC && g.c % vec == 0 &&
         static_cast<long long>(g.ct) * g.ctiles * vec >= g.c && g.nb > 0 &&
         static_cast<long long>(g.nb) * g.rpb >= g.rows_split && g.ctiles <= 65535 && g.splits <= 65535;
}

}  // namespace

extern "C" {

// Every entry point: x (and g, y, dx) [splits * rows_split, C] with C
// innermost and the rows dense, bf16 (bf16 = 1) or float32 (bf16 = 0), each
// pointer aligned to vec elements; stats and means float32 [2][splits][C];
// scale and bias float32 [C]; part float32 scratch [splits][nb][2][C]. The
// geometry (rows_split, rpb, C, splits, vec, ct, ctiles, rpi, nb) is
// ops/batch_norm.py plan()'s.

// stats <- (mean, mean of squares) of each split: two launches
int bn_stats(const void* x, void* part, void* stats, int bf16, long long rows_split, long long rpb, int c,
             int splits, int vec, int ct, int ctiles, int rpi, int nb, void* stream) {
  const Geom g = geom(rows_split, rpb, c, splits, ct, ctiles, rpi, nb);
  auto fn = PICK(run_stats, bf16, vec);
  if (fn == nullptr || !valid(g, vec)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(x, static_cast<float*>(part), static_cast<float*>(stats), g,
                             static_cast<cudaStream_t>(stream)));
}

// y <- x * T(w) + T(b)
int bn_apply(const void* x, void* y, const void* stats, const void* scale, const void* bias, float eps,
             int bf16, long long rows_split, long long rpb, int c, int splits, int vec, int ct, int ctiles,
             int rpi, int nb, void* stream) {
  const Geom g = geom(rows_split, rpb, c, splits, ct, ctiles, rpi, nb);
  auto fn = PICK(run_apply, bf16, vec);
  if (fn == nullptr || !valid(g, vec)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(x, y, static_cast<const float*>(stats), static_cast<const float*>(scale),
                             static_cast<const float*>(bias), eps, g, static_cast<cudaStream_t>(stream)));
}

// means <- (mean g, mean g * xh) of each split; totals [2][C] <- their sums
// over every row (the bias's and the scale's gradients): two launches
int bn_grad_stats(const void* gy, const void* x, const void* stats, float eps, void* part, void* means,
                  void* totals, int bf16, long long rows_split, long long rpb, int c, int splits, int vec,
                  int ct, int ctiles, int rpi, int nb, void* stream) {
  const Geom g = geom(rows_split, rpb, c, splits, ct, ctiles, rpi, nb);
  auto fn = PICK(run_grad_stats, bf16, vec);
  if (fn == nullptr || !valid(g, vec)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(gy, x, static_cast<const float*>(stats), eps, static_cast<float*>(part),
                             static_cast<float*>(means), static_cast<float*>(totals), g,
                             static_cast<cudaStream_t>(stream)));
}

// dx <- scale * r * (g - mean_g - xh * mean_gxh)
int bn_dx(const void* gy, const void* x, const void* stats, const void* means, const void* scale, float eps,
          void* dx, int bf16, long long rows_split, long long rpb, int c, int splits, int vec, int ct,
          int ctiles, int rpi, int nb, void* stream) {
  const Geom g = geom(rows_split, rpb, c, splits, ct, ctiles, rpi, nb);
  auto fn = PICK(run_dx, bf16, vec);
  if (fn == nullptr || !valid(g, vec)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(gy, x, static_cast<const float*>(stats), static_cast<const float*>(means),
                             static_cast<const float*>(scale), eps, dx, g, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
