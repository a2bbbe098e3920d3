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
//   run: neighbouring threads take neighbouring elements;
// * a tile narrower than a row and at least a warp wide walks each row
//   contiguously;
// * a narrower strip (`gelu_naive`: 1024 rows x 8 columns) has each warp
//   walk 32 rows down one column, every lane in its own 32-byte sector,
//   so one load instruction uses 4 (f32) or 2 (bf16) of each sector's 32
//   bytes and the strip re-reads its sectors column by column.
// Every walk computes each element with the same instructions, so the
// layouts agree bit for bit.  Offsets are 64-bit (the padded C = 3 case
// holds 1.7e9 elements); each thread keeps 8 loads in flight.
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
constexpr int kUnroll = 8;
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

}  // namespace

extern "C" int gelu_2d_launch(const void* x, void* y, long long rows,
                              long long cols, int tile_r, int tile_c,
                              int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || tile_r <= 0 || tile_c <= 0 ||
      static_cast<int64_t>(tile_r) * tile_c > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles =
      ((rows + tile_r - 1) / tile_r) * ((cols + tile_c - 1) / tile_c);
  const dim3 grid(static_cast<unsigned>(n_tiles < kMaxBlocks ? n_tiles
                                                             : kMaxBlocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gelu_2d_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), rows, cols,
        tile_r, tile_c);
  } else if (dtype == 1) {
    gelu_2d_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        rows, cols, tile_r, tile_c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
