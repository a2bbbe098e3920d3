// Average pooling (window x window, stride = window, no padding) for
// Hopper (sm_90a): the blocked (NHWC) and naive (NCHW) walks.
//
// Replaces the Pallas TPU kernels `_pool_nhwc_kernel` / `avg_pool_blocked`
// (src/repro/kernels/avgpool.py:37) and `_pool_nchw_kernel` /
// `avg_pool_naive` (avgpool.py:65).  Every output is the float32 sum of
// its window, taken row by row from 0.0, divided by window^2 and rounded
// once to the input dtype; rows and columns past the last whole window
// are cropped, as the reference crops them.
//
// Bound on the card: bytes (window^2 + 1 FLOPs per output, about 0.2 FLOP
// a byte).  The paper's section 3.3 contrasts a blocked layout, whose
// channels fill the SIMD register, with NCHW, whose spatial stride-2
// window sums do not.  The two kernels keep that contrast:
// * pool_nhwc (blocked): neighbouring threads take neighbouring channel
//   vectors (16 bytes: 4 float32 or 8 bf16) of one output pixel, so each
//   of a window's loads is one coalesced 16-byte access per thread; a
//   grid-stride loop covers any N, H, W and C (scalar channels where C or
//   the pointers do not allow 16 bytes);
// * pool_nchw (naive, on the NCHW tensor the wrapper transposed): one
//   block per (n, c) plane, threads across the output's W, so each
//   thread reads `window` neighbouring values from each of `window` rows
//   and neighbouring threads read `window` elements apart — W in the fast
//   dimension, as the Pallas kernel puts W in the lanes.
// Both walks add a window's values in the same order and divide the same
// way, so they agree bit for bit.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int pool_nhwc_launch(x, y, n, h, w, c, window, dtype, stream)
//   int pool_nchw_launch(x, y, planes, h, w, window, dtype, stream)
// (dtype 0 f32, 1 bf16; the NCHW input is (planes, h, w)); each returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

using dtype_io::to_f32;

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

// WIN > 0 fixes the window at compile time (the main path's 2, fully
// unrolled); 0 reads `window`.  Both kernels add a window row by row.
template <typename T, int V, int WIN>
__global__ void __launch_bounds__(kThreads)
    pool_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y, int n, int h,
                     int w, int c, int window) {
  const int win = WIN > 0 ? WIN : window;
  const int ho = h / win, wo = w / win;
  const int64_t cv = c / V;
  const int64_t total = static_cast<int64_t>(n) * ho * wo * cv;
  const float area = static_cast<float>(win * win);
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t ch = (idx % cv) * V;
    int64_t p = idx / cv;
    const int64_t oj = p % wo;
    p /= wo;
    const int64_t oi = p % ho;
    const int64_t b = p / ho;
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.0f;
#pragma unroll
    for (int i = 0; i < win; ++i) {
      const T* src = x + ((b * h + oi * win + i) * w + oj * win) * c + ch;
#pragma unroll
      for (int j = 0; j < win; ++j) {
        float v[V];
        if (V > 1) {
          dtype_io::load16(src + static_cast<int64_t>(j) * c, v);
        } else {
          v[0] = to_f32(src[static_cast<int64_t>(j) * c]);
        }
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] += v[u];
      }
    }
    T* dst = y + ((b * ho + oi) * wo + oj) * c + ch;
    float out[V];
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = acc[u] / area;
    if (V > 1) {
      dtype_io::store16(dst, out);
    } else {
      dtype_io::store(dst, out[0]);
    }
  }
}

template <typename T, int WIN>
__global__ void __launch_bounds__(kThreads)
    pool_nchw_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w,
                     int window) {
  const int win = WIN > 0 ? WIN : window;
  const int ho = h / win, wo = w / win;
  const float area = static_cast<float>(win * win);
  const T* xp = x + static_cast<int64_t>(blockIdx.x) * h * w;
  T* yp = y + static_cast<int64_t>(blockIdx.x) * ho * wo;
  for (int o = threadIdx.x; o < ho * wo; o += blockDim.x) {
    const int oi = o / wo, oj = o % wo;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < win; ++i) {
      const T* src = xp + static_cast<int64_t>(oi * win + i) * w + oj * win;
#pragma unroll
      for (int j = 0; j < win; ++j) acc += to_f32(src[j]);
    }
    dtype_io::store(yp + o, acc / area);
  }
}

template <typename T, int V>
cudaError_t nhwc(const void* x, void* y, int n, int h, int w, int c,
                 int window, cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(n) * (h / window) *
                        (w / window) * (c / V);
  if (total == 0) return cudaSuccess;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (window == 2) {
    pool_nhwc_kernel<T, V, 2><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(xt, yt, n, h, w, c, window);
  } else {
    pool_nhwc_kernel<T, V, 0><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(xt, yt, n, h, w, c, window);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t nhwc_any(const void* x, void* y, int n, int h, int w, int c,
                     int window, cudaStream_t s) {
  constexpr int V = dtype_io::vec16<T>();
  const bool vec = c % V == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  return vec ? nhwc<T, V>(x, y, n, h, w, c, window, s)
             : nhwc<T, 1>(x, y, n, h, w, c, window, s);
}

template <typename T>
cudaError_t nchw(const void* x, void* y, long long planes, int h, int w,
                 int window, cudaStream_t s) {
  const int outs = (h / window) * (w / window);
  if (outs == 0) return cudaSuccess;
  int threads = ((outs + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (window == 2) {
    pool_nchw_kernel<T, 2><<<static_cast<unsigned>(planes), threads, 0, s>>>(
        xt, yt, h, w, window);
  } else {
    pool_nchw_kernel<T, 0><<<static_cast<unsigned>(planes), threads, 0, s>>>(
        xt, yt, h, w, window);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int pool_nhwc_launch(const void* x, void* y, int n, int h, int w,
                                int c, int window, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(nhwc_any<float>(x, y, n, h, w, c, window, s));
  if (dtype == 1)
    return static_cast<int>(
        nhwc_any<__nv_bfloat16>(x, y, n, h, w, c, window, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pool_nchw_launch(const void* x, void* y, long long planes,
                                int h, int w, int window, int dtype,
                                void* stream) {
  if (planes <= 0 || planes > 0x7fffffffLL || h <= 0 || w <= 0 ||
      window <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(nchw<float>(x, y, planes, h, w, window, s));
  if (dtype == 1)
    return static_cast<int>(
        nchw<__nv_bfloat16>(x, y, planes, h, w, window, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
