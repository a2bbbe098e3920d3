// Inner product (fully connected) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mm_kernel` / `inner_product` in
// src/repro/kernels/inner_product.py:52: out (M, N) = epilogue(x (M, K) @
// w (K, N)) with a float32 accumulator, epilogue none / relu / tanh-GELU
// applied to the float32 sum (the paper's fused "warm cache" case: the
// activation never goes back to device memory), output rounded once to the
// input type.  The Pallas kernel carries the accumulator across a
// sequential K grid axis; here each block loops over K itself and keeps
// the accumulator in registers.
//
// Bound on the card: operations for large square products (8192^3 in bf16
// is ~1.1 TFLOP against ~400 MB: 1.112 ms at the data sheet's 989 TFLOP/s),
// bytes for a thin M (qwen3-14b's gate projection over a 256-token prefill
// chunk, 256 x 5120 x 17408, reads 178 MB of w: 0.0567 ms at 3.35 TB/s;
// AI 240, just left of the bf16 ridge of ~295).
//
// bf16 runs on the tensor cores (csrc/gemm_wgmma.cuh): 128 x 256 tiles, or
// 128 x 128 where those finish in fewer whole waves (the gate projection:
// 272 tiles in three waves of 132 SMs against 136 wider ones in two; the
// third wave's 8 tiles leave the card mostly idle for a tile's time, the
// price of the quantisation); K staged 64 at a time in a ring of 4 or 5
// stages under the 128-byte swizzle.  At a thin M the row tiles of one
// column of w are neighbours in launch order, so w is read from memory
// once.  Producers, chosen here per operand: x by TMA when K % 8 == 0
// (16-byte rows), w by TMA, read in its (K, N) layout, when N % 8 == 0;
// otherwise that operand element-wise (bounds-checked loads into the same
// swizzled stage).  Every bf16 shape takes the wgmma consumers.
// float32 stays on the CUDA cores (csrc/gemm_core.cuh): a full float32
// product, as torch.matmul computes it by default; x by 16-byte copies
// when K % 4 == 0, w when N % 4 == 0 (each 16-byte aligned), else that
// operand element by element.
//
// Any M, N, K >= 1, float32 or bf16 inputs.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int inner_product_launch(x, w, out, M, N, K,
//                            epilogue /*0 none, 1 relu, 2 gelu*/,
//                            dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape, epilogue or dtype the kernel does not take);
//   int inner_product_plan(x, w, M, N, K, dtype)
// returns the launch's plan: in bf16 wg::plan_code (producers of x and w,
// and BN), in float32 gemm::plan_code (producers of x and w; negative).
// A bf16 launch fails if a tensor map it needs cannot be encoded.

#include "gemm_core.cuh"
#include "gemm_wgmma.cuh"

namespace {

template <int WA, int WB>
__global__ void __launch_bounds__(gemm::kThreads, gemm::kMinBlocks)
    inner_product_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ out, int M, int N, int K,
                             int epilogue, bool vec_c) {
  const gemm::DenseA<WA> a{x, K, M, K, 0};
  const gemm::DenseB<WB> b{w, N, K, N, 0};
  gemm::gemm_tile(a, b, out, N, M, N, K, epilogue, vec_c);
}

template <int BN, class ALoad, class BLoad>
__global__ void __launch_bounds__(wg::kThreads, 1)
    inner_product_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                              const __grid_constant__ CUtensorMap map_w,
                              ALoad a, BLoad b, wg::Out o) {
  wg::gemm_block<BN>(&map_x, &map_w, a, b, o);
}

struct Plan {
  bool tma_x, tma_w;
  int bn;
};

Plan plan_for(const void* x, const void* w, int M, int N, int K) {
  Plan p;
  p.tma_x = K % 8 == 0 && wg::aligned16(x);
  p.tma_w = N % 8 == 0 && wg::aligned16(w);
  p.bn = (p.tma_x && p.tma_w) ? wg::pick_bn(M, N) : 128;
  return p;
}

template <int BN, class ALoad, class BLoad>
int launch_bf16(const CUtensorMap& mx, const CUtensorMap& mw, ALoad a,
                BLoad b, const wg::Out& o, cudaStream_t s) {
  return wg::launch<BN>(inner_product_bf16_kernel<BN, ALoad, BLoad>, o.M,
                        o.N, s, mx, mw, a, b, o);
}

int launch_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                int epilogue, cudaStream_t s) {
  const Plan p = plan_for(x, w, M, N, K);
  CUtensorMap mx = {}, mw = {};
  if (p.tma_x && !wg::make_map(&mx, x, M, K, wg::BM))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.tma_w && !wg::make_map(&mw, w, K, N, wg::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::Out o{static_cast<__nv_bfloat16*>(out), M, N, K, epilogue};
  wg::DenseView view;
  view.p = static_cast<const uint16_t*>(x);
  view.M = M;
  view.Kdim = K;
  const wg::ElemA<wg::DenseView> ex{view};
  const wg::ElemB<128> ew{static_cast<const uint16_t*>(w), K, N};
  if (p.tma_x && p.tma_w) {
    if (p.bn == 256)
      return launch_bf16<256>(mx, mw, wg::TmaA{}, wg::TmaB<256>{}, o, s);
    return launch_bf16<128>(mx, mw, wg::TmaA{}, wg::TmaB<128>{}, o, s);
  }
  if (p.tma_x) return launch_bf16<128>(mx, mw, wg::TmaA{}, ew, o, s);
  if (p.tma_w) return launch_bf16<128>(mx, mw, ex, wg::TmaB<128>{}, o, s);
  return launch_bf16<128>(mx, mw, ex, ew, o, s);
}

}  // namespace

extern "C" int inner_product_plan(const void* x, const void* w, int M, int N,
                                  int K, int dtype) {
  if (dtype == 0) return gemm::plan_code(gemm::producer(x, K),
                                         gemm::producer(w, N));
  const Plan p = plan_for(x, w, M, N, K);
  return wg::plan_code(p.tma_x ? wg::kTma : wg::kElement,
                       p.tma_w ? wg::kTma : wg::kElement, p.bn);
}

extern "C" int inner_product_launch(const void* x, const void* w, void* out,
                                    int M, int N, int K, int epilogue,
                                    int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || epilogue < 0 || epilogue > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const bool vec_c = gemm::producer(out, N) == gemm::kVec;
    return gemm::with_widths(
        gemm::producer(x, K), gemm::producer(w, N), [&](auto wa, auto wb) {
          return gemm::launch(
              inner_product_f32_kernel<decltype(wa)::value,
                                       decltype(wb)::value>,
              M, N, 1, s, static_cast<const float*>(x),
              static_cast<const float*>(w), static_cast<float*>(out), M, N,
              K, epilogue, vec_c);
        });
  }
  if (dtype == 1) return launch_bf16(x, w, out, M, N, K, epilogue, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
