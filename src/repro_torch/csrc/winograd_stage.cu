// Winograd F(2x2, 3x3) elementwise stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wino_mm_kernel` /
// `winograd_elementwise_stage` in src/repro/kernels/conv_winograd.py:
// m[p] (T, Cout) = v[p] (T, Cin) @ u[p] (Cin, Cout) for each of the 16
// positions p of the transformed 4 x 4 tile, all in float32.  The input and
// output transforms stay plain tensor code (kernels/conv_winograd.py), as
// in the reference; this stage holds the whole multiply reduction: 16
// products per 2 x 2 output patch and input channel, against 36 for the
// direct convolution, 2.25x less work.
//
// Bound on the card: at ResNet-50 conv3_x over a batch of 256 (T = 50176
// tiles, Cin = Cout = 128) it is 26.3 GFLOP against 823 MB of float32 v,
// u and m, so float32 operations bound it (0.393 ms at the data sheet's
// 67 TFLOP/s; the bytes need 0.246 ms at 3.35 TB/s), and the two are close
// enough that loads, FMAs and stores must overlap.  It is the float32
// GEMM core (csrc/gemm_core.cuh: a 2-stage cp.async ring, 8 x 8 outputs a
// thread in four quadrants, float4 stores) with the position p as the
// batch index (blockIdx.z); v streams through the ring once, u[p] (64 KB)
// is re-read by each of p's row tiles from L2, and m is written once.
// v's and u's producers are chosen per operand: 16-byte copies when Cin
// (for v) or Cout (for u) is a multiple of 4 and the tensor is 16-byte
// aligned, else one copy per element.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int winograd_stage_launch(v, u, m, positions, tiles, cin, cout, stream)
// returns cudaGetLastError() after the launch;
//   int winograd_stage_plan(v, u, positions, tiles, cin, cout)
// returns the launch's plan (gemm::plan_code: the producers of v and u).

#include "gemm_core.cuh"

namespace {

template <int WA, int WB>
__global__ void __launch_bounds__(gemm::kThreads, gemm::kMinBlocks)
    winograd_stage_f32_kernel(const float* __restrict__ v,
                              const float* __restrict__ u,
                              float* __restrict__ m, int T, int Cin, int Cout,
                              bool vec_c) {
  const int64_t p = blockIdx.z;
  const gemm::DenseA<WA> a{v + p * T * Cin, Cin, T, Cin, 0};
  const gemm::DenseB<WB> b{u + p * Cin * Cout, Cout, Cin, Cout, 0};
  gemm::gemm_tile(a, b, m + p * T * Cout, Cout, T, Cout, Cin, gemm::kNone,
                  vec_c);
}

}  // namespace

extern "C" int winograd_stage_plan(const void* v, const void* u,
                                   int positions, int T, int Cin, int Cout) {
  return gemm::plan_code(gemm::producer(v, Cin), gemm::producer(u, Cout));
}

extern "C" int winograd_stage_launch(const void* v, const void* u, void* m,
                                     int positions, int T, int Cin, int Cout,
                                     void* stream) {
  if (positions <= 0 || positions > 65535 || T <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_c = gemm::producer(m, Cout) == gemm::kVec;
  return gemm::with_widths(
      gemm::producer(v, Cin), gemm::producer(u, Cout), [&](auto wa, auto wb) {
        return gemm::launch(
            winograd_stage_f32_kernel<decltype(wa)::value,
                                      decltype(wb)::value>,
            T, Cout, positions, static_cast<cudaStream_t>(stream),
            static_cast<const float*>(v), static_cast<const float*>(u),
            static_cast<float*>(m), T, Cin, Cout, vec_c);
      });
}
