// Direct 2-D convolution (NHWC, HWIO, stride 1, SAME) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_conv_kernel` / `conv2d_direct` in
// src/repro/kernels/conv_direct.py:49.  The Pallas kernel keeps one image's
// padded plane in VMEM and sums KH * KW shifted (H W, Cin) @ (Cin, Cout)
// products.  Here the same sum is one implicit GEMM:
//
//   out (N H W, Cout) = A (N H W, KH KW Cin) @ w (KH KW Cin, Cout)
//   A[(n, oh, ow)][(dh, dw, ci)] = x[n, oh + dh - ph, ow + dw - pw, ci]
//
// with ph = KH / 2 and pw = KW / 2 rows / columns of zero padding before
// and KH - 1 - ph / KW - 1 - pw after, the split of conv_direct.py:46, so
// even kernel sizes agree with the reference.  A is never built: its
// loader computes each row's pixel address from (m, k) and reads 0
// outside the image (the padding costs no memory).  HWIO weights are
// already the row-major (KH KW Cin, Cout) B.  In NHWC the K index walks
// Cin fastest, so one pixel's channels are contiguous, the Hopper form of
// keeping C in the TPU's lane dimension.
//
// Bound on the card: operations (ResNet-50 conv3_x at batch 256 in bf16,
// 200704 x 1152 x 128, is 59.2 GFLOP against ~100 MB: 0.0599 ms at the
// data sheet's 989 TFLOP/s).
//
// bf16 runs on the tensor cores (csrc/gemm_wgmma.cuh): 128 x 128 tiles
// (Cout 128 is one column of tiles), K staged 64 at a time in a ring of 5
// stages under the 128-byte swizzle.  Producers, chosen here per operand:
// A by 16-byte `cp.async` copies when Cin % 8 == 0 (eight channels of one
// pixel and one tap; thread t of the producer warpgroup copies chunk t % 8
// of rows t / 8 + 16 j, whose pixel coordinates it computes once per
// tile, and one tap / channel split per stage), else element-wise (Cin 3,
// 5: the same view, element by element); w by TMA when Cout % 8 == 0,
// else element-wise.  Every bf16 shape takes the wgmma consumers.
// float32 stays on the CUDA cores (csrc/gemm_core.cuh).
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int conv2d_direct_launch(x, w, out, n, h, w, cin, cout, kh, kw,
//                            dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch;
//   int conv2d_direct_plan(x, w, n, h, w, cin, cout, kh, kw, dtype)
// returns the bf16 launch's plan (wg::plan_code: producers of A and w, and
// BN), or -1 for float32 (CUDA cores).

#include "gemm_core.cuh"
#include "gemm_wgmma.cuh"

namespace {

// float32 A as the im2col view of an NHWC image with SAME padding, for the
// CUDA-core GEMM.
struct ConvA {
  const float* __restrict__ x;
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
    return x[base[i] + (static_cast<int64_t>(ih) * W + iw) * Cin + ci];
  }
};

__global__ void __launch_bounds__(gemm::kThreads)
    conv2d_direct_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ out, int N, int H, int W,
                             int Cin, int Cout, int KH, int KW) {
  ConvA a;
  a.x = x;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.KW = KW;
  a.ph = KH / 2;
  a.pw = KW / 2;
  gemm::gemm_tile<float, float>(a, w, Cout, out, Cout, N * H * W, Cout,
                                KH * KW * Cin, gemm::kNone);
}

// bf16 A as the im2col view, for the wgmma producers: rows j < kRows of a
// producer thread (tile rows pt / 8 + 16 j) keep their pixel; kinfo splits
// a K index into its tap offset and channel.
struct ConvView {
  static constexpr int kRows = wg::BM / 16;
  struct K { int dy, dx, ci; bool ok; };
  const uint16_t* __restrict__ p;
  int M, H, W, Cin, KW, ph, pw, Kdim;
  int oh[kRows], ow[kRows];
  int64_t base[kRows];                 // offset of image n
  bool ok[kRows];

  __device__ void set_row(int j, int m) {
    ok[j] = m < M;
    const int mm = ok[j] ? m : 0;
    const int n = mm / (H * W);
    const int r = mm - n * H * W;
    oh[j] = r / W;
    ow[j] = r - oh[j] * W;
    base[j] = static_cast<int64_t>(n) * H * W * Cin;
  }
  __device__ K kinfo(int k) const {
    const bool in = k < Kdim;
    const int tap = in ? k / Cin : 0;
    const int dh = tap / KW;
    return K{dh - ph, tap - dh * KW - pw, k - tap * Cin, in};
  }
  // element offset of (row j, k) in x; valid false in the padding
  __device__ int64_t offset(int j, K k, bool& valid) const {
    const int ih = oh[j] + k.dy, iw = ow[j] + k.dx;
    valid = ok[j] && k.ok && static_cast<unsigned>(ih) < unsigned(H) &&
            static_cast<unsigned>(iw) < unsigned(W);
    return base[j] + (static_cast<int64_t>(ih) * W + iw) * Cin + k.ci;
  }
  __device__ uint16_t get(int j, K k) const {
    bool valid;
    const int64_t off = offset(j, k, valid);
    return valid ? p[off] : 0;
  }
};

// A by 16-byte cp.async (Cin % 8 == 0, x 16-byte aligned): thread pt
// copies chunk c = pt % 8 (channels of one pixel and tap) of rows
// pt / 8 + 16 j into the swizzled stage, zeros in the padding.
struct CpConvA {
  static constexpr int kKind = wg::kCpAsync;
  ConvView v;
  __device__ void set_tile(int m0, int pt) {
#pragma unroll
    for (int j = 0; j < ConvView::kRows; ++j)
      v.set_row(j, m0 + pt / 8 + 16 * j);
  }
  __device__ void fill(uint8_t* dst, int k0, int pt) const {
    const int c = pt % 8, r0 = pt / 8;
    const ConvView::K kk = v.kinfo(k0 + 8 * c);
    const int sw = (c ^ (r0 & 7)) * 16;
#pragma unroll
    for (int j = 0; j < ConvView::kRows; ++j) {
      bool valid;
      const int64_t off = v.offset(j, kk, valid);
      wg::cp_async16(dst + (r0 + 16 * j) * 128 + sw,
                     valid ? v.p + off : v.p, valid);
    }
  }
};

template <class ALoad, class BLoad>
__global__ void __launch_bounds__(wg::kThreads, 1)
    conv2d_direct_bf16_kernel(const __grid_constant__ CUtensorMap map_w,
                              ALoad a, BLoad b, wg::Out o) {
  wg::gemm_block<128>(nullptr, &map_w, a, b, o);
}

bool cp_async_a(const void* x, int Cin) {
  return Cin % 8 == 0 && wg::aligned16(x);
}

bool tma_w(const void* w, int Cout) {
  return Cout % 8 == 0 && wg::aligned16(w);
}

template <class ALoad, class BLoad>
int launch_bf16(const CUtensorMap& mw, ALoad a, BLoad b, const wg::Out& o,
                cudaStream_t s) {
  return wg::launch<128>(conv2d_direct_bf16_kernel<ALoad, BLoad>, o.M, o.N,
                         s, mw, a, b, o);
}

int launch_bf16(const void* x, const void* w, void* out, int N, int H, int W,
                int Cin, int Cout, int KH, int KW, cudaStream_t s) {
  const int M = N * H * W, K = KH * KW * Cin;
  CUtensorMap mw = {};
  const bool b_tma = tma_w(w, Cout);
  if (b_tma && !wg::make_map(&mw, w, K, Cout, wg::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::Out o{static_cast<__nv_bfloat16*>(out), M, Cout, K, wg::kNone};
  ConvView v;
  v.p = static_cast<const uint16_t*>(x);
  v.M = M;
  v.H = H;
  v.W = W;
  v.Cin = Cin;
  v.KW = KW;
  v.ph = KH / 2;
  v.pw = KW / 2;
  v.Kdim = K;
  const wg::ElemB<128> eb{static_cast<const uint16_t*>(w), K, Cout};
  if (cp_async_a(x, Cin)) {
    const CpConvA a{v};
    return b_tma ? launch_bf16(mw, a, wg::TmaB<128>{}, o, s)
                 : launch_bf16(mw, a, eb, o, s);
  }
  const wg::ElemA<ConvView> a{v};
  return b_tma ? launch_bf16(mw, a, wg::TmaB<128>{}, o, s)
               : launch_bf16(mw, a, eb, o, s);
}

}  // namespace

extern "C" int conv2d_direct_plan(const void* x, const void* w, int N, int H,
                                  int W, int Cin, int Cout, int KH, int KW,
                                  int dtype) {
  if (dtype == 0) return -1;
  return wg::plan_code(cp_async_a(x, Cin) ? wg::kCpAsync : wg::kElement,
                       tma_w(w, Cout) ? wg::kTma : wg::kElement, 128);
}

extern "C" int conv2d_direct_launch(const void* x, const void* w, void* out,
                                    int N, int H, int W, int Cin, int Cout,
                                    int KH, int KW, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || KH <= 0 ||
      KW <= 0 || static_cast<int64_t>(N) * H * W > INT32_MAX ||
      static_cast<int64_t>(KH) * KW * Cin > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv2d_direct_f32_kernel<<<gemm::grid_for(N * H * W, Cout, 1),
                               gemm::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), N, H, W, Cin, Cout, KH, KW);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1)
    return launch_bf16(x, w, out, N, H, W, Cin, Cout, KH, KW, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
