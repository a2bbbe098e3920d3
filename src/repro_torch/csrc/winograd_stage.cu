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
// tiles, Cin = Cout = 128) it is ~26 GFLOP against ~820 MB of float32 v,
// u and m, so float32 operations bound it (AI ~32 FLOP/B against the data
// sheet's float32 ridge of ~20: 67 TFLOP/s over 3.35 TB/s).  It is the
// inner product's GEMM core (csrc/gemm_core.cuh) with the position p as
// the batch index (blockIdx.z).
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int winograd_stage_launch(v, u, m, positions, tiles, cin, cout, stream)
// returns cudaGetLastError() after the launch.

#include "gemm_core.cuh"

namespace {

__global__ void __launch_bounds__(gemm::kThreads)
    winograd_stage_kernel(const float* __restrict__ v,
                          const float* __restrict__ u, float* __restrict__ m,
                          int T, int Cin, int Cout) {
  const int64_t p = blockIdx.z;
  gemm::DenseA<float> a;
  a.p = v + p * T * static_cast<int64_t>(Cin);
  a.ld = Cin;
  gemm::gemm_tile<float, float>(
      a, u + p * Cin * static_cast<int64_t>(Cout), Cout,
      m + p * T * static_cast<int64_t>(Cout), Cout, T, Cout, Cin,
      gemm::kNone);
}

}  // namespace

extern "C" int winograd_stage_launch(const void* v, const void* u, void* m,
                                     int positions, int T, int Cin, int Cout,
                                     void* stream) {
  if (positions <= 0 || positions > 65535 || T <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  winograd_stage_kernel<<<gemm::grid_for(T, Cout, positions), gemm::kThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(u),
      static_cast<float*>(m), T, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}
