// Peak float32 FMA rate of the card's CUDA cores: the paper's
// runtime-generated FMA chains (section 2.1) as a hand-written probe.
//
// Each thread runs kChains independent float32 FMA chains v = v * a + b in
// registers for `iters` steps (independent chains hide the FMA latency, as
// the paper rotates zmm0..zmm7), then stores the chains' sum so the
// compiler cannot drop them.  a and b are runtime arguments and the loop
// count is not a compile-time constant, so nothing folds; without
// --use_fast_math the compiler does not reassociate the chain.  Work:
// 2 * kChains * iters FLOPs per thread.  On an H100 SXM the ceiling is
// 132 SMs x 128 float32 lanes x 2 FLOP x the SM clock (~67 TFLOP/s at the
// data sheet's boost clock).
//
// C interface (bound with ctypes by repro_torch/core/roofline/microbench.py):
//   int fma_probe_launch(out, blocks, threads, iters, a, b, stream)
// out holds blocks * threads floats; returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

__global__ void fma_probe_kernel(float* __restrict__ out, int iters, float a,
                                 float b) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  float v[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) v[c] = 1e-3f * (tid % 97) + c;
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) v[c] = fmaf(v[c], a, b);
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += v[c];
  out[tid] = s;
}

}  // namespace

extern "C" int fma_probe_chains() { return kChains; }

extern "C" int fma_probe_launch(void* out, int blocks, int threads, int iters,
                                float a, float b, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024 || iters <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fma_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters, a, b);
  return static_cast<int>(cudaGetLastError());
}
