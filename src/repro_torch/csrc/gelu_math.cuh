// tanh-approximate GELU in float32, the one definition shared by the GELU
// kernel (csrc/gelu.cu) and the inner product's fused epilogue
// (csrc/inner_product.cu), as the Pallas kernels share it
// (src/repro/kernels/gelu.py::_gelu_kernel, inner_product.py::_mm_kernel):
//
//   gelu(x) = 0.5 x (1 + tanh(c (x + 0.044715 x^3))),  c = sqrt(2 / pi)
//
// tanhf is the accurate libdevice tanh (no --use_fast_math, no __tanhf
// intrinsic), so the kernel differs from the plain PyTorch version only by
// a few float32 ulps.
#pragma once

__device__ __forceinline__ float gelu_f32(float x) {
  const float c = 0.7978845608028654f;
  const float x3 = x * x * x;
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x3)));
}
