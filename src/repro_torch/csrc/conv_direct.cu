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
// float32 stays on the CUDA cores (csrc/gemm_core.cuh): A by 16-byte
// `cp.async` copies of 4 channels of one pixel and tap when Cin % 4 == 0
// (x 16-byte aligned), else element-wise; w by 16-byte copies when
// Cout % 4 == 0, else element-wise.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int conv2d_direct_launch(x, w, out, n, h, w, cin, cout, kh, kw,
//                            dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch;
//   int conv2d_direct_plan(x, w, n, h, w, cin, cout, kh, kw, dtype)
// returns the launch's plan: in bf16 wg::plan_code (producers of A and w,
// and BN), in float32 gemm::plan_code (producers of A and w; negative).

#include "gemm_core.cuh"
#include "gemm_wgmma.cuh"

namespace {

// float32 A as the im2col view of an NHWC image with SAME padding, for the
// CUDA-core GEMM: copies of W = 4 channels of one pixel and tap (Cin % 4
// == 0) or of one element, zeros in the padding and past M and K.  Row m
// is pixel m (offset m Cin in x); a thread keeps the (oh, ow) of its first
// row in the tile and steps it to its other rows, kRowStep pixels apart.
template <int W>
struct ConvA {
  using S = gemm::Slots<W, gemm::BM, gemm::BK>;
  const float* __restrict__ x;
  int M, K, H, W_, Cin, KW, ph, pw;
  int m0, oh0, ow0;

  __device__ __forceinline__ void set_tile(int m) {
    m0 = m;
    const int r = (m0 + S::row(threadIdx.x, 0)) % (H * W_);
    oh0 = r / W_;
    ow0 = r - oh0 * W_;
  }
  __device__ __forceinline__ void fill(float* as, int k0) const {
    const int t = threadIdx.x, c = S::col(t), k = k0 + c;
    const int tap = k / Cin, ci = k - tap * Cin;
    const int dh = tap / KW;
    const int dy = dh - ph, dx = tap - dh * KW - pw;
    const int64_t shift = (static_cast<int64_t>(dy) * W_ + dx) * Cin + ci;
    int oh = oh0, ow = ow0;
#pragma unroll
    for (int j = 0; j < S::kCopies; ++j) {
      if (j > 0) {                     // the next row, kRowStep pixels on
        ow += S::kRowStep;
        while (ow >= W_) {
          ow -= W_;
          if (++oh == H) oh = 0;
        }
      }
      const int r = S::row(t, j), m = m0 + r;
      const bool ok = m < M && k < K &&
                      static_cast<unsigned>(oh + dy) <
                          static_cast<unsigned>(H) &&
                      static_cast<unsigned>(ow + dx) <
                          static_cast<unsigned>(W_);
      gemm::copy<W>(as + r * gemm::kAStride + c,
                    ok ? x + static_cast<int64_t>(m) * Cin + shift : x, ok);
    }
  }
};

template <int WA, int WB>
__global__ void __launch_bounds__(gemm::kThreads, gemm::kMinBlocks)
    conv2d_direct_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ out, int N, int H, int W,
                             int Cin, int Cout, int KH, int KW, bool vec_c) {
  const int M = N * H * W, K = KH * KW * Cin;
  ConvA<WA> a;
  a.x = x;
  a.M = M;
  a.K = K;
  a.H = H;
  a.W_ = W;
  a.Cin = Cin;
  a.KW = KW;
  a.ph = KH / 2;
  a.pw = KW / 2;
  const gemm::DenseB<WB> b{w, Cout, K, Cout, 0};
  gemm::gemm_tile(a, b, out, Cout, M, Cout, K, gemm::kNone, vec_c);
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
  if (dtype == 0)
    return gemm::plan_code(gemm::producer(x, Cin), gemm::producer(w, Cout));
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
    const bool vec_c = gemm::producer(out, Cout) == gemm::kVec;
    return gemm::with_widths(
        gemm::producer(x, Cin), gemm::producer(w, Cout), [&](auto wa, auto wb) {
          return gemm::launch(
              conv2d_direct_f32_kernel<decltype(wa)::value,
                                       decltype(wb)::value>,
              N * H * W, Cout, 1, s, static_cast<const float*>(x),
              static_cast<const float*>(w), static_cast<float*>(out), N, H,
              W, Cin, Cout, KH, KW, vec_c);
        });
  }
  if (dtype == 1)
    return launch_bf16(x, w, out, N, H, W, Cin, Cout, KH, KW, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
