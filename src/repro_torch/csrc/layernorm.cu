// Row LayerNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ln_kernel` / `layernorm` in
// src/repro/kernels/layernorm.py: for each row of x viewed as (R, D),
//   mu  = mean(x),  var = mean((x - mu)^2)        (two passes, float32)
//   y   = (x - mu) * rsqrt(var + eps) * scale + bias
// with scale and bias read as float32 and y rounded once to x's dtype.
//
// Bound on the card: bytes.  Each element is read once and written once
// (about 0.5 FLOP a byte in float32, far left of the ridge).  The Pallas
// kernel keeps a (256, D) row block in VMEM so the two passes cost no
// extra HBM traffic; here a row is staged once in shared memory as
// float32 and both passes and the output pass read it from there:
// * D <= 1024: a warp per row, 8 rows a block, sums by warp shuffles;
// * larger D: a block of 256 threads per row, sums by shuffles and one
//   exchange through shared memory.  Past 48 KB of staged row the launch
//   raises the dynamic shared-memory limit (D up to 57344).
// Accesses are 16 bytes wide over each row's aligned body, in device
// memory and in shared memory alike (the staged row is shifted by 0-3
// floats so its body is aligned there too: no bank conflicts), with a
// scalar head up to the first 16-byte boundary and a bounds-checked
// scalar tail, so any R, any D and any row alignment work.  The square,
// the scaling and the bias are rounded as the reference rounds them
// (__fmul_rn / __fadd_rn: no contraction into FMAs).
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int layernorm_launch(x, scale, bias, y, rows, d, eps,
//                        dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

using dtype_io::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRowMaxD = 1024;
constexpr int kMaxD = 57344;              // 224 KB of staged row

// Elements of T before the first 16-byte boundary of the row at p (at
// most d).
template <typename T>
__device__ __forceinline__ int row_head(const T* p, int d) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const int head = mis == 0 ? 0 : (16 - mis) / static_cast<int>(sizeof(T));
  return head < d ? head : d;
}

// n float32 values (n a multiple of 4) at p, as float4 accesses where p is
// 16-byte aligned (shared or global memory), else one by one.
__device__ __forceinline__ void get_f32(const float* p, float* out, int n) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    for (int q = 0; q < n; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      out[q] = v.x;
      out[q + 1] = v.y;
      out[q + 2] = v.z;
      out[q + 3] = v.w;
    }
  } else {
    for (int q = 0; q < n; ++q) out[q] = p[q];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the row's threads; every thread of the row gets the result.
template <bool kWarpPerRow>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if (kWarpPerRow) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();                      // red is reused by the next sum
  return s;
}

// Shared-memory floats a staged row takes: d rounded up to 4, plus the
// 0-3 floats that shift the row so its 16-byte body lands 16-byte aligned.
__host__ __device__ __forceinline__ int staged_floats(int d) {
  return (d + 3) / 4 * 4 + 4;
}

template <typename T, bool kWarpPerRow>
__global__ void __launch_bounds__(kThreads)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y,
                     int64_t rows, int d, float eps) {
  constexpr int V = dtype_io::vec16<T>();
  extern __shared__ __align__(16) float stage[];
  __shared__ float red[kWarps];
  const int warp = threadIdx.x / 32;
  const int64_t row = kWarpPerRow
                          ? static_cast<int64_t>(blockIdx.x) * kWarps + warp
                          : static_cast<int64_t>(blockIdx.x);
  const int t = kWarpPerRow ? threadIdx.x % 32 : threadIdx.x;
  const int n = kWarpPerRow ? 32 : kThreads;
  if (row >= rows) return;              // whole warps only (warp mode)
  const T* xr = x + row * d;
  T* yr = y + row * d;
  // element i of the row is staged at srow[i]; srow + hx is 16-byte aligned
  const int hx = row_head(xr, d);
  float* srow = stage + (kWarpPerRow ? warp * staged_floats(d) : 0) +
                (4 - hx % 4) % 4;
  const float inv_d = 1.0f / static_cast<float>(d);

  // pass 1: stage the row as float32 (16-byte accesses both sides), sum
  float sum = 0.0f;
  const int nvx = (d - hx) / V;
  for (int i = t; i < hx; i += n) {
    srow[i] = to_f32(xr[i]);
    sum += srow[i];
  }
#pragma unroll 4
  for (int j = t; j < nvx; j += n) {
    float v[V];
    dtype_io::load16(xr + hx + j * V, v);
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      *reinterpret_cast<float4*>(srow + hx + j * V + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      sum += v[q] + v[q + 1] + v[q + 2] + v[q + 3];
    }
  }
  for (int i = hx + nvx * V + t; i < d; i += n) {
    srow[i] = to_f32(xr[i]);
    sum += srow[i];
  }
  if (kWarpPerRow) __syncwarp();
  const float mu = row_sum<kWarpPerRow>(sum, red) * inv_d;

  // pass 2: the mean of squared deviations, from the staged row
  float sq = 0.0f;
  for (int i = t; i < d; i += n) {
    const float dv = srow[i] - mu;
    sq = __fadd_rn(sq, __fmul_rn(dv, dv));
  }
  const float var = row_sum<kWarpPerRow>(sq, red) * inv_d;
  const float rstd = rsqrtf(var + eps);

  // pass 3: normalise, scale, shift; 16-byte stores over y's aligned body
  auto norm = [&](float v, float g, float c) {
    return __fadd_rn(__fmul_rn(__fmul_rn(v - mu, rstd), g), c);
  };
  const int hy = row_head(yr, d);
  const int nvy = (d - hy) / V;
  for (int i = t; i < hy; i += n)
    dtype_io::store(yr + i, norm(srow[i], scale[i], bias[i]));
  for (int j = t; j < nvy; j += n) {
    const int i0 = hy + j * V;
    float v[V], g[V], c[V];
    get_f32(srow + i0, v, V);
    get_f32(scale + i0, g, V);
    get_f32(bias + i0, c, V);
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = norm(v[u], g[u], c[u]);
    dtype_io::store16(yr + i0, v);
  }
  for (int i = hy + nvy * V + t; i < d; i += n)
    dtype_io::store(yr + i, norm(srow[i], scale[i], bias[i]));
}

template <typename T, bool kWarpPerRow>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* y, long long rows, int d, float eps,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(
                                          staged_floats(d) *
                                          (kWarpPerRow ? kWarps : 1));
  auto kernel = layernorm_kernel<T, kWarpPerRow>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = kWarpPerRow ? (rows + kWarps - 1) / kWarps : rows;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int layernorm_launch(const void* x, const void* scale,
                                const void* bias, void* y, long long rows,
                                int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool warp_rows = d <= kWarpRowMaxD;
  cudaError_t e;
  if (dtype == 0) {
    e = warp_rows ? launch<float, true>(x, scale, bias, y, rows, d, eps, s)
                  : launch<float, false>(x, scale, bias, y, rows, d, eps, s);
  } else if (dtype == 1) {
    e = warp_rows
            ? launch<__nv_bfloat16, true>(x, scale, bias, y, rows, d, eps, s)
            : launch<__nv_bfloat16, false>(x, scale, bias, y, rows, d, eps,
                                           s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
