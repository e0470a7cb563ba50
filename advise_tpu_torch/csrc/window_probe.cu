// The window gather of the nine Mosaic probe kernels, hand-written for
// Hopper (sm_90a) CUDA cores.
//
// Replaces the nine Pallas kernels of scripts/probe_mosaic_aot.py (lead_dyn
// :76, sub_dyn :99, sub_aligned :123, val_dslice :138, roll_dyn :153,
// aug_like :180, aug_like_aligned :207, roll_lane :236, flat_u8 :263). Each
// reads a window of its input at an offset that arrives at run time (the
// scalar-prefetched int32 of the TPU kernels; here the kernel arguments o0
// and o1, so one compiled kernel serves every offset) and writes it out:
//
//   for each of the 4 axes a of the (rank-padded) input, with v = scale[a]
//   times the run-time offset named by src[a] (0 when src[a] < 0):
//     start = base[a] + v                      align[a] == 1 (pl.ds at v)
//           = base[a] + (v // align) * align   align[a] >  1 (pl.multiple_of)
//           = base[a]                          align[a] == 0 (whole axis)
//           = clamp(base[a] + v, 0, in - out)  clamp[a]      (lax.dynamic_slice)
//     index(i) = start + i                                   wrap[a] == 0
//              = start + (i + base + v - start) mod wrap[a]  wrap[a] >  0
//                (pltpu.roll by -(v - start) within a window of wrap[a])
//   out = input[index_0(i0), ..., index_3(i3)] cast u8 -> i32 -> f32 where
//   the input is uint8, summed over i0 in order when sum_axis0 is set.
//
// The wrapper (ops/window_probe.py) computes the same indices on the host
// and raises before the launch when one falls outside its axis: the DMA of
// the TPU kernels could not read past the end, and neither does this.
//
// Bound on the card: bytes, and at the probes' sizes (at most 66 KB read
// and 64 KB written) a launch's fixed cost, some microseconds, is all of
// it. Design: one thread per output element, each computing its own input
// index; neighbouring threads take neighbouring elements of the last axis,
// so reads and writes coalesce wherever the window is not rolled.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. The C entry point launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RANK = 4;
constexpr int THREADS = 256;

struct WindowSpec {
  int in_shape[RANK];   // input extents
  int out_shape[RANK];  // window extents (axis 0 summed when sum_axis0)
  int base[RANK];       // static start
  int src[RANK];        // run-time offset that moves the axis: 0, 1, or -1
  int scale[RANK];      // its multiplier
  int align[RANK];      // 1: at the offset; > 1: aligned down; 0: at base
  int clamp[RANK];      // 1: start clamped into [0, in - out]
  int wrap[RANK];       // > 0: rolled within a window of this many elements
  int sum_axis0;
  int u8;               // input type: 1 uint8, 0 float32
};

__device__ __forceinline__ int floor_div(int a, int b) {  // Python's a // b, b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int window_index(const WindowSpec& s, int a, int i, int o0, int o1) {
  const int v = s.src[a] < 0 ? 0 : s.scale[a] * (s.src[a] == 0 ? o0 : o1);
  int start;
  if (s.clamp[a]) {
    start = min(max(s.base[a] + v, 0), s.in_shape[a] - s.out_shape[a]);
  } else if (s.align[a] == 0) {
    start = s.base[a];
  } else {
    start = s.base[a] + floor_div(v, s.align[a]) * s.align[a];
  }
  if (s.wrap[a] > 0) {
    const int r = (s.base[a] + v - start) % s.wrap[a];  // the roll's shift
    return start + (i + r + s.wrap[a]) % s.wrap[a];
  }
  return start + i;
}

__device__ __forceinline__ float load(const void* x, int64_t off, int u8) {
  if (u8) return static_cast<float>(static_cast<int32_t>(static_cast<const uint8_t*>(x)[off]));
  return static_cast<const float*>(x)[off];
}

__global__ void window_gather_kernel(const void* __restrict__ x, float* __restrict__ y,
                                     WindowSpec s, int o0, int o1, int64_t n_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  int64_t stride[RANK];
  stride[RANK - 1] = 1;
  for (int a = RANK - 2; a >= 0; --a) stride[a] = stride[a + 1] * s.in_shape[a + 1];
  const int first = s.sum_axis0 ? 1 : 0;
  int64_t rem = e, off = 0;
  for (int a = RANK - 1; a >= first; --a) {
    const int i = static_cast<int>(rem % s.out_shape[a]);
    rem /= s.out_shape[a];
    off += static_cast<int64_t>(window_index(s, a, i, o0, o1)) * stride[a];
  }
  float acc;
  if (s.sum_axis0) {
    acc = load(x, off + window_index(s, 0, 0, o0, o1) * stride[0], s.u8);
    for (int i0 = 1; i0 < s.out_shape[0]; ++i0)
      acc += load(x, off + window_index(s, 0, i0, o0, o1) * stride[0], s.u8);
  } else {
    acc = load(x, off, s.u8);
  }
  y[e] = acc;
}

}  // namespace

extern "C" {

// x: the input (uint8 or float32, contiguous, of in_shape); y: float32 of
// the window's shape (axis 0 dropped when summed). The ten int arrays are
// RANK long each, in the order of WindowSpec.
int window_gather(const void* x, void* y, const int* in_shape, const int* out_shape,
                  const int* base, const int* src, const int* scale, const int* align,
                  const int* clamp, const int* wrap, int sum_axis0, int u8, int o0, int o1,
                  void* stream) {
  WindowSpec s;
  int64_t n_out = 1;
  for (int a = 0; a < RANK; ++a) {
    s.in_shape[a] = in_shape[a];
    s.out_shape[a] = out_shape[a];
    s.base[a] = base[a];
    s.src[a] = src[a];
    s.scale[a] = scale[a];
    s.align[a] = align[a];
    s.clamp[a] = clamp[a];
    s.wrap[a] = wrap[a];
    if (a > 0 || !sum_axis0) n_out *= out_shape[a];
  }
  s.sum_axis0 = sum_axis0;
  s.u8 = u8;
  const int64_t blocks = (n_out + THREADS - 1) / THREADS;
  window_gather_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, static_cast<float*>(y), s, o0,
                                                              o1, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
