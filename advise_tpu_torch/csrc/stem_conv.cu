// SlowFast fast-pathway stem convolution, forward and weight gradient,
// hand-written for Hopper (sm_90a) as tensor-core implicit GEMMs.
//
// Replaces the TPU kernels of advise_tpu/ops/pallas/stem_conv.py:
//   stem_fwd_kernel             <- _fwd_kernel    (launched by _fwd, pallas_s2d_stem)
//   stem_wgrad_partial_kernel   <- _wgrad_kernel  (launched by _wgrad_raw/_wgrad, _vjp_bwd)
//     + stem_wgrad_reduce_kernel
//
// What it computes (the function, not the TPU formulation): the
// (kt,7,7)/s(1,2,2), pad (kt//2,3,3) conv of a raw NDHWC clip with C = 3
// input and F = 8 output channels, kt odd,
//   y[b,t,i,j,f] = sum_{dt,dy,dx,c} x[b, t+dt-kt/2, 2i+dy-3, 2j+dx-3, c] * w[dt,dy,dx,c,f]
//   dW[dt,dy,dx,c,f] = sum_{b,t,i,j} x[...] * g[b,t,i,j,f]
// with bf16 inputs and f32 accumulation (forward emits bf16, the weight
// gradient f32). The TPU kernels' Toeplitz column packing exists only to
// fill the 128-lane MXU and is not carried over.
//
// Bound on the card, at the preset (2 views x 16 clips x 32 frames x 224^2):
// 2 * 5*7*7*3*8 = 11,760 FLOP per output pixel over 12.8M output pixels is
// 1.51e11 FLOP per direction, 0.153 ms at the 989 TFLOP/s bf16 tensor-core
// rate, and equally 513 MB of device-memory traffic (the 308 MB bf16 clip
// read once, the 205 MB stem output written or read once), 0.153 ms at
// 3.35 TB/s. On the CUDA cores (67 TFLOP/s float32) the same FLOP take 2.25
// ms at best, so both kernels run on the tensor cores.
//
// Design against that bound:
//  - space-to-depth in shared memory: each frame of a block's tile is staged
//    once, as bf16, in the 2x2 space-to-depth layout of
//    advise_tpu/models/layers/stem.py (s2d_repack_input): a cell holds the
//    12 values (ph, pw, c) of one 2x2 pixel block, padded with zeros to 16
//    channels (32 bytes). The conv is then a stride-1 (kt,4,4) conv over
//    cells with the weight remapped to [kt,4,4,16,8] (s2d_remap_kernel, cell
//    padding 2 before and 1 after), an implicit GEMM with K = kt*4*4*16 =
//    1280 at kt 5 (the zero taps inflate 735 to 1280) and N = 8. For one
//    output row of 16 positions and one (dt, ah, aw) tap the 16 x 16 A tile
//    is 16 consecutive cells of one staged row: ldmatrix gathers it with one
//    row address per lane. The two 16-byte halves of a cell swap places in
//    every other group of 4 cells, so the 8 rows of each 8x8 matrix fall on
//    distinct banks (a 32-byte stride alone is 2-way conflicted);
//  - tensor cores: mma.sync m16n8k16, bf16 in, float32 accumulators; N = 8
//    is exactly the n of the instruction, so no column is wasted;
//  - K1 (forward): a warp owns R = 7 output rows x 16 columns and keeps their
//    7 accumulator tiles in registers. It loads each A tile (one staged row,
//    one aw) once and multiplies it into every output row that reads that
//    staged row (the 4 ah taps), so a warp issues 10 ldmatrix.x4 for 28 mma
//    per (dt, aw). The weight's B fragments (20 KB at kt 5) are built once a
//    block into shared memory and read 16 per temporal tap;
//  - K2 (weight gradient): dW2^T [taps x 8] += im2col^T x G, reduced over
//    positions. The A tiles are the same staged cells through ldmatrix.trans
//    and the B tiles the staged g rows (16 bytes a position) through
//    ldmatrix.trans. A warp owns one temporal tap, two aw and all four ah: 8
//    accumulator tiles (32 registers) held across everything its block
//    walks. It walks the staged rows once, 12 to an unrolled loop step: each
//    A tile feeds 4 ah taps, each g row the 4 staged rows that read it (a
//    window of 4 B fragments);
//  - temporal reuse and asynchronous copies: one block walks a contiguous
//    range of (clip, tile, frame) work items in frame order and keeps the
//    frames those need in a ring in shared memory (K2 splits kt into groups
//    of at most 5 taps, one grid row each, and rings the group's frames).
//    Each step stages only the one frame that enters the window, by
//    cp.async straight into the s2d layout (4 bytes a copy: the raw -> s2d
//    re-layout is the copies' addressing; zero-filled outside the frame),
//    while the current item multiplies: K1 copies it into the slot its tap
//    dt = 0 has just freed (a barrier after that tap; the ring stays kt
//    frames), K2 into a slot of its own (dg + 1 frames: each warp owns one
//    tap, so none frees early). K2 stages g's rows through registers, loaded
//    an item ahead. Every input byte is thus read once plus the halo (59 x
//    19 cells for 56 x 16 outputs), where the CUDA-core kernels read each
//    frame kt times; an odd W, whose cell rows are not 4-byte aligned, takes
//    plain loads through registers instead;
//  - the grid: one persistent block a SM (its ring takes 195-224 KB of
//    shared memory), 132 blocks, each owning an equal contiguous share of
//    the work items: one whole wave. ops/stem_conv.py plan() states the
//    tile, grid, ring and partials; the wrappers pass them in;
//  - the sum order of an output position depends only on its taps (dt, then
//    ah, then aw, then the instruction's 16-term sum), never on the block or
//    the launch, so a forward launched per batch chunk (K1') is bit-equal to
//    one launch. K2 writes one float32 partial a block; the reduce kernel
//    sums the partials in a fixed order and collapses the s2d taps back to
//    [kt,7,7,3,8], dropping the zero taps: no atomics, so the weight
//    gradient is bit-equal between runs;
//  - epilogue: the m16n8 accumulator layout puts a position's 8 channels on
//    4 neighbouring lanes, 2 each, so each lane stores one bf16 pair and a
//    warp's store covers 8 positions' 128 contiguous bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC. Each C entry point launches on the given stream and
// returns cudaGetLastError() (cudaErrorInvalidValue for a plan these
// kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 3;                  // RGB input channels
constexpr int F = 8;                  // fast-stem output channels
constexpr int KS = 7;                 // spatial kernel
constexpr int TW = 16;                // output columns of a tile: one m16 tile
constexpr int R = 7;                  // output rows of a K1 warp
constexpr int CW = TW + 3;            // staged cells a row: 2 halo before, 1 after
constexpr int CELL = 32;              // bytes a staged cell: 12 + 4 zero bf16
constexpr int TAPS = 16;              // (ah, aw) s2d taps of one temporal tap
constexpr int FWD_MAX_WARPS = 8;
constexpr int WG_MAX_DG = 5;          // temporal taps of a K2 group
constexpr int WG_MAX_THREADS = 2 * WG_MAX_DG * 32;
constexpr int PFG_WG = 3;             // g positions a K2 thread holds: 3 * 320 >= 56 * 16
constexpr int WG_STEP = 12;           // staged rows a K2 loop step (unrolled; a multiple of 4)
constexpr int WG_TILE = TAPS * 16 * F;  // floats of one temporal tap's dW2 tiles
constexpr int RED_ROWS = 8;           // threads summing one weight's partials
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory a block may use

// One launch's geometry: the frame, the tile and the work items.
struct Geo {
  int T, H, W, Ho, Wo;
  int th;              // output rows of a tile
  int tiles_x, ntiles; // tiles of a frame
  long long items;     // B * ntiles * T (clip, tile, frame) work items
  bool even_w;         // W even: a cell's rows are 4-byte aligned (cp.async)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Global loads as volatile asm: K2's loads of the next g frame issue where
// they stand, ahead of the MMAs that follow, and their registers are read
// only after them.
__device__ __forceinline__ uint32_t ldg_u16(const bf16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ldg_u128(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint2 ldsm_x2_t(uint32_t addr) {
  uint2 r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r.x), "=r"(r.y)
               : "r"(addr));
  return r;
}

// d += a b: m16n8k16, bf16 in, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The 12 values of s2d cell (cr, cc) of a frame [H, W, 3] as 6 words, one
// bf16 at a time (any alignment): row ph's 2 pixels x 3 channels (contiguous
// in the frame) are words 3ph..3ph+2, so the channel order is (ph, pw, c).
// Zero outside the frame.
__device__ __forceinline__ void load_cell(const bf16* frame, const Geo& g, int cr, int cc,
                                          uint32_t (&v)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = 0u;
#pragma unroll
  for (int ph = 0; ph < 2; ++ph) {
    const int r = 2 * cr + ph;
    if (r < 0 || r >= g.H) continue;
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int q = 2 * cc + e / 3;
      if (q >= 0 && q < g.W) {
        v[3 * ph + e / 2] |= ldg_u16(frame + ((size_t)r * g.W + q) * C + e % 3) << (16 * (e & 1));
      }
    }
  }
}

// Cell (lr, lc) of a staged frame: channels 0-7 and 8-15 in its two 16-byte
// halves, which trade places when (lc / 4) is odd.
__device__ __forceinline__ void store_cell(unsigned char* slot, int lr, int lc,
                                           const uint32_t (&v)[6]) {
  unsigned char* cell = slot + (lr * CW + lc) * CELL;
  const int sw = (lc >> 2) & 1;
  *reinterpret_cast<uint4*>(cell + 16 * sw) = make_uint4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<uint4*>(cell + 16 * (sw ^ 1)) = make_uint4(v[4], v[5], 0u, 0u);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const bf16* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage a frame of a tile into `slot`. For an even W by cp.async, 4 bytes a
// copy straight into the s2d layout, zero-filled outside the frame (the pad
// channels 12-15 are never written: they stay as the block zeroed them); for
// an odd W, whose cell rows are not 4-byte aligned, through registers.
__device__ void stage_frame(unsigned char* slot, const bf16* frame, const Geo& g, int i0,
                            int j0) {
  const int ncells = (g.th + 3) * CW;
  for (int e = threadIdx.x; e < ncells; e += blockDim.x) {
    const int lr = e / CW, lc = e - lr * CW;
    const int cr = i0 - 2 + lr, cc = j0 - 2 + lc;
    if (g.even_w) {
      const uint32_t cell = smem_addr(slot + (lr * CW + lc) * CELL);
      const int sw = (lc >> 2) & 1;
      const bool col = cc >= 0 && 2 * cc < g.W;  // W even: both of the cell's columns
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const int r = 2 * cr + ph;
        const bool ok = col && r >= 0 && r < g.H;
        const bf16* src = ok ? frame + ((size_t)r * g.W + 2 * cc) * C : frame;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int wi = 3 * ph + k;  // word wi of the cell: channels 2 wi, 2 wi + 1
          cp_async4(cell + 16 * ((wi >> 2) ^ sw) + 4 * (wi & 3), src + 2 * k, ok);
        }
      }
    } else {
      uint32_t v[6];
      load_cell(frame, g, cr, cc, v);
      store_cell(slot, lr, lc, v);
    }
  }
}

// Byte offset, in a staged row, of the 16 bytes that lane-row `pos` of an
// ldmatrix reads for tap aw and channel half `half`.
__device__ __forceinline__ int cell_offset(int pos, int aw, int half) {
  const int lc = pos + aw;
  return lc * CELL + 16 * (half ^ ((lc >> 2) & 1));
}

// The output gradient's frame of a tile: [th][16] positions of 16 bytes,
// zero past Ho and Wo.
template <int PF>
struct GradCopy {
  uint4 v[PF];

  __device__ __forceinline__ static bool valid(const Geo& g, int i0, int j0, int e) {
    return i0 + e / TW < g.Ho && j0 + e % TW < g.Wo;
  }

  __device__ __forceinline__ static const bf16* at(const bf16* frame, const Geo& g, int i0,
                                                   int j0, int e) {
    return frame + ((size_t)(i0 + e / TW) * g.Wo + j0 + e % TW) * F;
  }

  __device__ __forceinline__ void load(const bf16* frame, const Geo& g, int i0, int j0) {
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (e < g.th * TW && valid(g, i0, j0, e)) v[k] = ldg_u128(at(frame, g, i0, j0, e));
    }
  }

  __device__ __forceinline__ void store(uint4* gs, const bf16* frame, const Geo& g, int i0,
                                        int j0) {
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e < g.th * TW) gs[e] = v[k];
    }
    for (int e = threadIdx.x + PF * blockDim.x; e < g.th * TW; e += blockDim.x) {
      gs[e] = valid(g, i0, j0, e) ? ldg_u128(at(frame, g, i0, j0, e)) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// A block's share [begin, end) of the work items: contiguous, equal to 1.
__device__ __forceinline__ void item_range(const Geo& g, long long& begin, long long& end) {
  begin = g.items * blockIdx.x / gridDim.x;
  end = g.items * (blockIdx.x + 1) / gridDim.x;
}

// Work item `it`: its frame t, clip b and tile origin (i0, j0).
__device__ __forceinline__ void item_at(const Geo& g, long long it, int& t, int& b, int& i0,
                                        int& j0) {
  t = (int)(it % g.T);
  const long long seg = it / g.T;
  const int tile = (int)(seg % g.ntiles);
  b = (int)(seg / g.ntiles);
  i0 = (tile / g.tiles_x) * g.th;
  j0 = (tile % g.tiles_x) * TW;
}

// grid (nblk), block 32 * th / R, dynamic shared memory kt * frame + kt *
// TAPS * 32 * 8 bytes (the ring, then the weight's B fragments).
__global__ void __launch_bounds__(FWD_MAX_WARPS * 32, 1)
stem_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ y, Geo g, int kt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int frame_bytes = (g.th + 3) * CW * CELL;
  unsigned char* ring = smem;
  uint2* wfrag = reinterpret_cast<uint2*>(smem + (size_t)kt * frame_bytes);
  const unsigned short* wbits = reinterpret_cast<const unsigned short*>(w);

  // B fragment of tap s = (dt, ah, aw) for lane l: k (the cell channel
  // (ph, pw, c)) 2(l%4) + {0, 1} and + 8, n = l / 4; zero for the pad
  // channels and for the taps the remap pads in front (dy or dx = -1).
  for (int e = threadIdx.x; e < kt * TAPS * 32; e += blockDim.x) {
    const int l = e & 31, s = e >> 5;
    const int dt = s / TAPS, ah = (s >> 2) & 3, aw = s & 3;
    uint32_t word[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      word[hh] = 0u;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ch = 2 * (l & 3) + 8 * hh + u;
        const int ph = ch / 6, pw = (ch / 3) & 1, c = ch % 3;
        const int dy = 2 * ah + ph - 1, dx = 2 * aw + pw - 1;
        if (ch < 12 && dy >= 0 && dx >= 0) {
          word[hh] |= (uint32_t)wbits[(((dt * KS + dy) * KS + dx) * C + c) * F + (l >> 2)] << (16 * u);
        }
      }
    }
    wfrag[e] = make_uint2(word[0], word[1]);
  }

  // lane-rows of the A tiles (non-transposed): position q, channel half
  int aoff[4];
  {
    const int q = (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
#pragma unroll
    for (int aw = 0; aw < 4; ++aw) aoff[aw] = cell_offset(q, aw, half);
  }

  // the pad channels of every staged cell stay zero (cp.async writes 12)
  for (int e = threadIdx.x; e < kt * frame_bytes / 16; e += blockDim.x) {
    reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int h = kt / 2;
  const size_t frame_elems = (size_t)g.H * g.W * C;
  long long begin, end;
  item_range(g, begin, end);
  for (long long it = begin; it < end; ++it) {
    int t, b, i0, j0;
    item_at(g, it, t, b, i0, j0);
    const bf16* clip = x + (size_t)b * g.T * frame_elems;
    if (it == begin || t == 0) {  // a new (clip, tile): stage its window
      for (int ts = max(0, t - h); ts <= min(g.T - 1, t + h); ++ts) {
        stage_frame(ring + (ts % kt) * frame_bytes, clip + ts * frame_elems, g, i0, j0);
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const bool next = it + 1 < end && t + 1 < g.T && t + 1 + h < g.T;

    float acc[R][4];
#pragma unroll
    for (int p = 0; p < R; ++p)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[p][k] = 0.f;

    for (int dt = 0; dt < kt; ++dt) {
      const int ts = t + dt - h;
      if (ts >= 0 && ts < g.T) {  // else temporal zero padding; uniform per block
        const uint32_t rows = smem_addr(ring + (ts % kt) * frame_bytes + warp * R * CW * CELL);
        uint2 bw[TAPS];
#pragma unroll
        for (int s = 0; s < TAPS; ++s) bw[s] = wfrag[(dt * TAPS + s) * 32 + lane];
#pragma unroll
        for (int rr = 0; rr < R + 3; ++rr) {  // staged rows of the warp's output rows
#pragma unroll
          for (int aw = 0; aw < 4; ++aw) {
            uint32_t a[4];
            ldsm_x4(a, rows + rr * CW * CELL + aoff[aw]);
#pragma unroll
            for (int ah = 0; ah < 4; ++ah) {
              const int p = rr - ah;  // the output row that reads staged row rr at tap ah
              if (p >= 0 && p < R) mma(acc[p], a, bw[ah * 4 + aw]);
            }
          }
        }
      }
      if (dt == 0) {
        // every warp is done with frame t - h: its slot takes frame t + h + 1,
        // copied while the other taps multiply
        __syncthreads();
        if (next) {
          stage_frame(ring + ((t + h + 1) % kt) * frame_bytes,
                      clip + (size_t)(t + h + 1) * frame_elems, g, i0, j0);
        }
      }
    }

    // position j0 + lane / 4 (+ 8): channels 2 (lane % 4) + {0, 1}
    const int jq = j0 + (lane >> 2);
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const int i = i0 + warp * R + p;
      if (i < g.Ho) {
        uint32_t* row = reinterpret_cast<uint32_t*>(y + ((((size_t)b * g.T + t) * g.Ho + i) * g.Wo) * F);
        if (jq < g.Wo) row[jq * 4 + (lane & 3)] = pack_bf16x2(acc[p][0], acc[p][1]);
        if (jq + 8 < g.Wo) row[(jq + 8) * 4 + (lane & 3)] = pack_bf16x2(acc[p][2], acc[p][3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // frame t + h + 1 is staged for the next item
  }
}

// grid (nblk, ceil(kt / dg)), block 64 * dg, dynamic shared memory (dg +
// 1) * frame + th * 16 * 16 bytes (the ring, then g's frame). Grid row
// `group` owns the temporal taps [group * dg, group * dg + dg) and block x
// writes their tiles of partial[x][kt][16 taps][16 channels][8]: its work
// items' sum. Warp w: temporal tap w / 2 of the group, aw 2 (w % 2) + {0, 1},
// all ah. The ring holds the dg frames an item reads and the one the next
// item adds, which cp.async copies while this item multiplies.
__global__ void __launch_bounds__(WG_MAX_THREADS, 1)
stem_wgrad_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                          float* __restrict__ partial, Geo g, int kt, int dg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int frame_bytes = (g.th + 3) * CW * CELL;
  const int slots = dg + 1;
  unsigned char* ring = smem;
  uint4* gs = reinterpret_cast<uint4*>(smem + (size_t)slots * frame_bytes);
  const int dt0 = blockIdx.y * dg;
  const int dt = dt0 + (warp >> 1);
  const bool active = dt < kt;
  const int aw0 = 2 * (warp & 1);

  // lane-rows of the transposed A tiles: position q, channel half
  int aoff[2];
  {
    const int q = (lane & 7) + ((lane >> 4) << 3), half = (lane >> 3) & 1;
#pragma unroll
    for (int k = 0; k < 2; ++k) aoff[k] = cell_offset(q, aw0 + k, half);
  }
  const uint32_t grow = smem_addr(gs) + (lane & 15) * 16;  // position lane % 16 of a g row

  float acc[4][2][4];
#pragma unroll
  for (int ah = 0; ah < 4; ++ah)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ah][k][e] = 0.f;

  // the pad channels of every staged cell stay zero (cp.async writes 12)
  for (int e = threadIdx.x; e < slots * frame_bytes / 16; e += blockDim.x) {
    reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int h = kt / 2;
  const int lo = dt0 - h;  // the window of frames at item t: [t + lo, t + lo + dg)
  const size_t frame_elems = (size_t)g.H * g.W * C;
  const size_t gframe_elems = (size_t)g.Ho * g.Wo * F;
  long long begin, end;
  item_range(g, begin, end);
  GradCopy<PFG_WG> gcopy;
  for (long long it = begin; it < end; ++it) {
    int t, b, i0, j0;
    item_at(g, it, t, b, i0, j0);
    const bf16* clip = x + (size_t)b * g.T * frame_elems;
    const bf16* gclip = gy + (size_t)b * g.T * gframe_elems;
    if (it == begin || t == 0) {  // a new (clip, tile): stage its window
      for (int ts = max(0, t + lo); ts <= min(g.T - 1, t + lo + dg - 1); ++ts) {
        stage_frame(ring + (ts % slots) * frame_bytes, clip + ts * frame_elems, g, i0, j0);
      }
      gcopy.load(gclip + t * gframe_elems, g, i0, j0);
      cp_async_wait_all();
    }
    gcopy.store(gs, gclip + t * gframe_elems, g, i0, j0);  // in flight since the last item
    __syncthreads();
    if (it + 1 < end && t + 1 < g.T) {
      const int ts = t + lo + dg;  // the frame the next item's window adds
      if (ts >= 0 && ts < g.T) {
        stage_frame(ring + (ts % slots) * frame_bytes, clip + ts * frame_elems, g, i0, j0);
      }
      gcopy.load(gclip + (t + 1) * gframe_elems, g, i0, j0);
    }

    const int ts = t + dt - h;
    if (active && ts >= 0 && ts < g.T) {  // uniform per warp
      const uint32_t rows = smem_addr(ring + (ts % slots) * frame_bytes);
      uint2 bwin[4];  // B fragments of g rows p, p - 1, p - 2, p - 3 at [p % 4]
      for (int lr0 = 0; lr0 < g.th + 3; lr0 += WG_STEP) {
#pragma unroll
        for (int s = 0; s < WG_STEP; ++s) {
          const int lr = lr0 + s;  // staged row; it feeds output row lr - ah at tap ah
          if (lr < g.th + 3) {
            bwin[s & 3] = lr < g.th ? ldsm_x2_t(grow + lr * TW * 16) : make_uint2(0u, 0u);
            uint32_t a[2][4];
#pragma unroll
            for (int k = 0; k < 2; ++k) ldsm_x4_t(a[k], rows + lr * CW * CELL + aoff[k]);
#pragma unroll
            for (int ah = 0; ah < 4; ++ah) {
              const int p = lr - ah;
              if (p >= 0 && p < g.th) {
#pragma unroll
                for (int k = 0; k < 2; ++k) mma(acc[ah][k], a[k], bwin[(s - ah) & 3]);
              }
            }
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next frame is staged, and g's frame is free
  }

  if (active) {
    // tile (ah, aw) of tap dt: rows = channels lane / 4 (+ 8), columns f =
    // 2 (lane % 4) + {0, 1}
    float* out = partial + ((size_t)blockIdx.x * kt + dt) * WG_TILE;
#pragma unroll
    for (int ah = 0; ah < 4; ++ah)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float* tile = out + (ah * 4 + aw0 + k) * 16 * F + (lane >> 2) * F + 2 * (lane & 3);
        *reinterpret_cast<float2*>(tile) = make_float2(acc[ah][k][0], acc[ah][k][1]);
        *reinterpret_cast<float2*>(tile + 8 * F) = make_float2(acc[ah][k][2], acc[ah][k][3]);
      }
  }
}

// grid ceil(n/32), block (32, RED_ROWS): dw[dt,dy,dx,c,f] = sum over blocks
// of partial[blk][dt][ah][aw][ch][f], its s2d tap (dy + 1 = 2 ah + ph, dx + 1
// = 2 aw + pw, ch = 6 ph + 3 pw + c); each of the RED_ROWS threads of a column
// sums a strided share in order, then the shares are summed in order.
__global__ void __launch_bounds__(32 * RED_ROWS)
stem_wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                         int nblk, int kt) {
  __shared__ float part[RED_ROWS][32];
  const int n = kt * KS * KS * C * F;
  const int k = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (k < n) {
    const int f = k % F, c = (k / F) % C, dx = (k / (F * C)) % KS;
    const int dy = (k / (F * C * KS)) % KS, dt = k / (F * C * KS * KS);
    const int ah = (dy + 1) >> 1, ph = (dy + 1) & 1, aw = (dx + 1) >> 1, pw = (dx + 1) & 1;
    const float* src = partial + (size_t)dt * WG_TILE + ((ah * 4 + aw) * 16 + 6 * ph + 3 * pw + c) * F + f;
    const size_t stride = (size_t)kt * WG_TILE;
#pragma unroll 4
    for (int i = threadIdx.y; i < nblk; i += RED_ROWS) s += src[(size_t)i * stride];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && k < n) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < RED_ROWS; ++r) total += part[r][threadIdx.x];
    dw[k] = total;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The geometry of a launch with tiles of th output rows; false for a shape
// or plan the kernels do not take.
bool make_geo(Geo& g, int B, int T, int H, int W, int kt, int th) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || kt <= 0 || kt % 2 == 0 || th <= 0) return false;
  g.T = T;
  g.H = H;
  g.W = W;
  g.Ho = (H - 1) / 2 + 1;
  g.Wo = (W - 1) / 2 + 1;
  g.th = th;
  g.tiles_x = ceil_div(g.Wo, TW);
  g.ntiles = g.tiles_x * ceil_div(g.Ho, th);
  g.items = (long long)B * g.ntiles * T;
  g.even_w = W % 2 == 0;
  return true;
}

int frame_bytes(int th) { return (th + 3) * CW * CELL; }

}  // namespace

extern "C" {

// Shared memory of one block of each kernel, in bytes, for the plan's
// tile rows th, kt and K2's group size dg (ops/stem_conv.py plan() holds
// the same arithmetic).
int stem_fwd_smem(int th, int kt) { return kt * frame_bytes(th) + kt * TAPS * 32 * 8; }
int stem_wgrad_smem(int th, int dg) { return (dg + 1) * frame_bytes(th) + th * TW * 16; }

// x [B,T,H,W,3] bf16, w [kt,7,7,3,8] bf16 -> y [B,T,Ho,Wo,8] bf16,
// Ho = (H-1)/2+1, Wo = (W-1)/2+1, kt odd. All contiguous; x and y 4-byte
// aligned. The plan: nw warps of R rows a tile, nblk persistent blocks.
int stem_fwd(const void* x, const void* w, void* y, int B, int T, int H, int W, int kt,
             int nw, int nblk, void* stream) {
  Geo g;
  const int smem = stem_fwd_smem(nw * R, kt);
  if (nw < 1 || nw > FWD_MAX_WARPS || nblk < 1 || smem > SMEM_LIMIT ||
      !make_geo(g, B, T, H, W, kt, nw * R)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(stem_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  stem_fwd_kernel<<<nblk, nw * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)y, g, kt);
  return (int)cudaGetLastError();
}

// x [B,T,H,W,3] bf16, g [B,T,Ho,Wo,8] bf16 (16-byte aligned) ->
// dw [kt,7,7,3,8] f32, through partial [nblk][kt][16][16][8] f32. The plan:
// tiles of th output rows, K2 groups of dg temporal taps, nblk blocks.
int stem_wgrad(const void* x, const void* gy, void* partial, void* dw, int B, int T, int H,
               int W, int kt, int th, int dg, int nblk, void* stream) {
  Geo g;
  const int smem = stem_wgrad_smem(th, dg);
  if (dg < 1 || dg > WG_MAX_DG || nblk < 1 || smem > SMEM_LIMIT ||
      !make_geo(g, B, T, H, W, kt, th)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(stem_wgrad_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nblk, ceil_div(kt, dg));
  stem_wgrad_partial_kernel<<<grid, 64 * dg, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)gy, (float*)partial, g, kt, dg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = kt * KS * KS * C * F;
  stem_wgrad_reduce_kernel<<<ceil_div(n, 32), dim3(32, RED_ROWS), 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)dw, nblk, kt);
  return (int)cudaGetLastError();
}

}  // extern "C"
