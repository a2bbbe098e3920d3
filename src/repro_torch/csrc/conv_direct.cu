// Direct 2-D convolution (NHWC, HWIO, stride 1, SAME) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_conv_kernel` / `conv2d_direct` in
// src/repro/kernels/conv_direct.py.  The Pallas kernel keeps one image's
// padded plane in VMEM and sums KH * KW shifted (H W, Cin) @ (Cin, Cout)
// products.  Here the same sum is one implicit GEMM:
//
//   out (N H W, Cout) = A (N H W, KH KW Cin) @ w (KH KW Cin, Cout)
//   A[(n, oh, ow)][(dh, dw, ci)] = x[n, oh + dh - ph, ow + dw - pw, ci]
//
// with ph = KH / 2 and pw = KW / 2 rows / columns of zero padding before
// and KH - 1 - ph / KW - 1 - pw after, the split of conv_direct.py:46, so
// even kernel sizes agree with the reference.  A is never built: the
// loader of csrc/gemm_core.cuh computes each element's address from (m, k)
// and reads 0 outside the image (the padding costs no memory).  HWIO
// weights are already the row-major (KH KW Cin, Cout) B.  In NHWC the
// K index walks Cin fastest, so neighbouring threads read neighbouring
// channels of one pixel (coalesced), the Hopper form of keeping C in the
// TPU's lane dimension.
//
// Bound on the card: operations (ResNet-50 conv3_x at batch 256 in bf16 is
// ~59 GFLOP against ~100 MB).  This first kernel multiplies on the CUDA
// cores in float32; tensor cores are later work.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int conv2d_direct_launch(x, w, out, n, h, w, cin, cout, kh, kw,
//                            dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch.

#include "gemm_core.cuh"

namespace {

// A as the im2col view of an NHWC image with SAME padding.
template <typename T>
struct ConvA {
  const T* __restrict__ x;
  int H, W, Cin, KW, ph, pw;
  int64_t base[gemm::kALoads];   // offset of image n
  int oh[gemm::kALoads], ow[gemm::kALoads];
  bool valid[gemm::kALoads];

  __device__ __forceinline__ void set_rows(const int* m, int M) {
#pragma unroll
    for (int i = 0; i < gemm::kALoads; ++i) {
      valid[i] = m[i] < M;
      const int mm = valid[i] ? m[i] : 0;
      const int n = mm / (H * W);
      const int r = mm - n * H * W;
      oh[i] = r / W;
      ow[i] = r - oh[i] * W;
      base[i] = static_cast<int64_t>(n) * H * W * Cin;
    }
  }
  __device__ __forceinline__ float load(int i, int k, int K) const {
    if (!valid[i] || k >= K) return 0.0f;
    const int ci = k % Cin;
    const int r = k / Cin;
    const int dw = r % KW;
    const int dh = r / KW;
    const int ih = oh[i] + dh - ph;
    const int iw = ow[i] + dw - pw;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return 0.0f;
    return gemm::to_f32(
        x[base[i] + (static_cast<int64_t>(ih) * W + iw) * Cin + ci]);
  }
};

template <typename T>
__global__ void __launch_bounds__(gemm::kThreads)
    conv2d_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ out, int N, int H, int W, int Cin,
                         int Cout, int KH, int KW) {
  ConvA<T> a;
  a.x = x;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.KW = KW;
  a.ph = KH / 2;
  a.pw = KW / 2;
  gemm::gemm_tile<T, T>(a, w, Cout, out, Cout, N * H * W, Cout,
                        KH * KW * Cin, gemm::kNone);
}

}  // namespace

extern "C" int conv2d_direct_launch(const void* x, const void* w, void* out,
                                    int N, int H, int W, int Cin, int Cout,
                                    int KH, int KW, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || KH <= 0 ||
      KW <= 0 || static_cast<int64_t>(N) * H * W > INT32_MAX ||
      static_cast<int64_t>(KH) * KW * Cin > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = gemm::grid_for(N * H * W, Cout, 1);
  if (dtype == 0) {
    conv2d_direct_kernel<float><<<grid, gemm::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), N, H, W, Cin, Cout, KH, KW);
  } else if (dtype == 1) {
    conv2d_direct_kernel<__nv_bfloat16><<<grid, gemm::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), N, H, W, Cin, Cout, KH, KW);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
