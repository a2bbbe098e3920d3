// tanh-GELU over a 2-D array for Hopper (sm_90a), blocked vs naive walk.
//
// Replaces the Pallas TPU kernel `_gelu_kernel` / `gelu_2d` in
// src/repro/kernels/gelu.py (with its `gelu_blocked` / `gelu_naive`
// tilings): y = gelu(x) per element, float32 arithmetic
// (csrc/gelu_math.cuh), output in the input type.
//
// Bound on the card: bytes.  The paper's GELU study (section 3.4) holds
// that an elementwise op's intensity does not depend on the layout unless
// the layout wastes memory transactions or forces padding.  The Pallas
// kernel shows the waste with (8k, 128) lane-major tiles against (128k, 8)
// tiles that fill 8 of the TPU's 128 lanes.  On Hopper the same contrast
// is coalesced against strided access, and the wrapper picks it through
// the tile shape (tile_r, tile_c) alone:
// * a tile of whole rows (tile_c == C, `gelu_blocked`) is one contiguous
//   run, so the whole array is one: `gelu_flat_kernel` walks it as 16-byte
//   vectors (8 bf16 or 4 float32 an access) in one pass, each block over
//   its own run of 4 x 256 vectors, each thread keeping its four vectors
//   (256 apart) in flight, with 32-bit indices where the vector count
//   allows, and a scalar head and tail where the base is not 16-byte
//   aligned or the length not a multiple of the vector (x and y must share
//   their offset from a 16-byte boundary: the wrapper allocates y so).
//   Measured (PERF.md): a grid of resident blocks striding over the
//   array took 10% longer, with or without the arithmetic;
// * a tile narrower than a row and at least a warp wide walks each row
//   contiguously: as 16-byte vectors plus a scalar remainder when the
//   base, the row stride and the tiles' first columns are 16-byte aligned
//   (`gelu_rows_kernel`), else one element an access;
// * a narrower strip (`gelu_naive`: 1024 rows x 8 columns) has each warp
//   walk 32 rows down one column, every lane in its own 32-byte sector,
//   so one load instruction uses 4 (f32) or 2 (bf16) of each sector's 32
//   bytes and the strip re-reads its sectors column by column.
// Every walk computes each element with the same instructions (gelu_f32,
// the accurate tanhf, and one round-to-nearest store), so the layouts
// agree bit for bit.  The strided walks use 64-bit offsets (the padded
// C = 3 case holds 1.7e9 elements) and keep 8 loads in flight a thread.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int gelu_2d_launch(x, y, rows, cols, tile_r, tile_c,
//                      dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;       // loads in flight a thread, strided walks
constexpr int kVecs = 4;         // 16-byte accesses in flight a thread
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// gelu of the 32-bit word w: one float32, or two bf16 (rounded to nearest
// even, as __float2bfloat16 rounds the scalar walks' stores)
__device__ __forceinline__ uint32_t gelu_word(uint32_t w, const float*) {
  return __float_as_uint(gelu_f32(__uint_as_float(w)));
}
__device__ __forceinline__ uint32_t gelu_word(uint32_t w,
                                              const __nv_bfloat16*) {
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(gelu_f32(f.x), gelu_f32(f.y));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// gelu of every element of the 16-byte access v (elements of T)
template <typename T>
__device__ __forceinline__ uint4 gelu_vec(uint4 v, const T* tag) {
  return make_uint4(gelu_word(v.x, tag), gelu_word(v.y, tag),
                    gelu_word(v.z, tag), gelu_word(v.w, tag));
}

// The whole array as one run: n elements, the first `head` of them before
// x's (and y's) first 16-byte boundary; I indexes the accesses (int32 when
// the host found their count under 2^31).  Block b takes the kVecs *
// kThreads accesses from b * kVecs * kThreads, thread t those kThreads
// apart from t; block 0 also the scalar head and tail.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    gelu_flat_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                     int head) {
  constexpr int V = 16 / sizeof(T);
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  uint4* __restrict__ yv = reinterpret_cast<uint4*>(y + head);
  const I n_vec = static_cast<I>((n - head) / V);
  const I first = static_cast<I>(blockIdx.x) * kVecs * kThreads;
  const I i = first + threadIdx.x;
  if (n_vec - first >= static_cast<I>(kVecs) * kThreads) {
    uint4 v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) v[k] = __ldg(xv + i + k * kThreads);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) yv[i + k * kThreads] = gelu_vec(v[k], x);
  } else {                             // the last, partial run
    for (I j = i; j < n_vec; j += kThreads) yv[j] = gelu_vec(__ldg(xv + j), x);
  }
  if (blockIdx.x == 0) {               // the scalar head and tail
    const int64_t tail = head + static_cast<int64_t>(n_vec) * V;
    const int t = threadIdx.x;
    if (t < head) store(y + t, gelu_f32(to_f32(x[t])));
    if (tail + t < n) store(y + tail + t, gelu_f32(to_f32(x[tail + t])));
  }
}

// Row-wise tiles at least a warp wide over 16-byte aligned rows whose tiles
// start 16-byte aligned: each row of a tile as vectors, then the columns
// past the last whole vector one element an access.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gelu_rows_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t R,
                     int64_t C, int tile_r, int tile_c) {
  constexpr int V = 16 / sizeof(T);
  const int64_t tiles_c = (C + tile_c - 1) / tile_c;
  const int64_t n_tiles = ((R + tile_r - 1) / tile_r) * tiles_c;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r0 = (t / tiles_c) * tile_r;
    const int64_t c0 = (t % tiles_c) * tile_c;
    const int rows = static_cast<int>(R - r0 < tile_r ? R - r0 : tile_r);
    const int w = static_cast<int>(C - c0 < tile_c ? C - c0 : tile_c);
    const int nv = w / V, rem = w - nv * V;
    const T* xt = x + r0 * C + c0;
    T* yt = y + r0 * C + c0;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * nv; e += kThreads) {
      const int64_t off = (e / nv) * C + (e % nv) * V;
      *reinterpret_cast<uint4*>(yt + off) =
          gelu_vec(__ldg(reinterpret_cast<const uint4*>(xt + off)), x);
    }
    for (int e = threadIdx.x; e < rows * rem; e += kThreads) {
      const int64_t off = (e / rem) * C + nv * V + e % rem;
      store(yt + off, gelu_f32(to_f32(xt[off])));
    }
  }
}

// Any tile, one element an access (the naive strips, and tiles the vector
// walks do not take).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gelu_2d_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t R,
                   int64_t C, int tile_r, int tile_c) {
  const int64_t tiles_c = (C + tile_c - 1) / tile_c;
  const int64_t n_tiles = ((R + tile_r - 1) / tile_r) * tiles_c;
  const int tile_elems = tile_r * tile_c;
  const int64_t total = R * C;
  const bool whole_rows = tile_c == C;
  const bool cols_fast = tile_c >= 32;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r0 = (t / tiles_c) * tile_r;
    const int64_t c0 = (t % tiles_c) * tile_c;
    for (int e0 = threadIdx.x; e0 < tile_elems; e0 += kUnroll * kThreads) {
      int64_t off[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int e = e0 + j * kThreads;
        bool ok = e < tile_elems;
        if (whole_rows) {                  // one contiguous run
          off[j] = r0 * C + e;
          ok = ok && off[j] < total;
        } else {
          const int64_t r = cols_fast ? r0 + e / tile_c : r0 + e % tile_r;
          const int64_t c = cols_fast ? c0 + e % tile_c : c0 + e / tile_r;
          off[j] = r * C + c;
          ok = ok && r < R && c < C;
        }
        if (!ok) off[j] = -1;
        v[j] = ok ? to_f32(x[off[j]]) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (off[j] >= 0) store(y + off[j], gelu_f32(v[j]));
    }
  }
}

template <typename T>
void launch(const T* x, T* y, int64_t R, int64_t C, int tile_r, int tile_c,
            cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ay = reinterpret_cast<uintptr_t>(y);
  const int64_t n = R * C;
  if (tile_c == C && ax % 16 == ay % 16 && ax % sizeof(T) == 0) {
    const int64_t head_elems = (16 - static_cast<int64_t>(ax % 16)) % 16
                               / static_cast<int64_t>(sizeof(T));
    const int head = static_cast<int>(n < head_elems ? n : head_elems);
    const int64_t n_vec = (n - head) / V;
    const int64_t run = int64_t{kThreads} * kVecs;
    const int64_t blocks = n_vec > 0 ? (n_vec + run - 1) / run : 1;
    if (n_vec + run < INT32_MAX) {
      gelu_flat_kernel<T, int><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(x, y, n, head);
    } else {
      gelu_flat_kernel<T, int64_t><<<static_cast<unsigned>(blocks), kThreads,
                                     0, s>>>(x, y, n, head);
    }
    return;
  }
  const int64_t n_tiles =
      ((R + tile_r - 1) / tile_r) * ((C + tile_c - 1) / tile_c);
  const dim3 grid(static_cast<unsigned>(n_tiles < kMaxBlocks ? n_tiles
                                                             : kMaxBlocks));
  const int64_t row_bytes = C * static_cast<int64_t>(sizeof(T));
  const bool tiles_aligned =
      tile_c >= C || (static_cast<int64_t>(tile_c) * sizeof(T)) % 16 == 0;
  if (tile_c >= 32 && ax % 16 == 0 && ay % 16 == 0 && row_bytes % 16 == 0 &&
      tiles_aligned) {
    gelu_rows_kernel<T><<<grid, kThreads, 0, s>>>(x, y, R, C, tile_r, tile_c);
  } else {
    gelu_2d_kernel<T><<<grid, kThreads, 0, s>>>(x, y, R, C, tile_r, tile_c);
  }
}

}  // namespace

extern "C" int gelu_2d_launch(const void* x, void* y, long long rows,
                              long long cols, int tile_r, int tile_c,
                              int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || tile_r <= 0 || tile_c <= 0 ||
      static_cast<int64_t>(tile_r) * tile_c > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch(static_cast<const float*>(x), static_cast<float*>(y), rows, cols,
           tile_r, tile_c, s);
  } else if (dtype == 1) {
    launch(static_cast<const __nv_bfloat16*>(x),
           static_cast<__nv_bfloat16*>(y), rows, cols, tile_r, tile_c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
