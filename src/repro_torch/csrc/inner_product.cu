// Inner product (fully connected) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mm_kernel` / `inner_product` in
// src/repro/kernels/inner_product.py: out (M, N) = epilogue(x (M, K) @
// w (K, N)) with a float32 accumulator, epilogue none / relu / tanh-GELU
// applied to the float32 sum (the paper's fused "warm cache" case: the
// activation never goes back to device memory), output rounded once to the
// input type.  The Pallas kernel carries the accumulator across a
// sequential K grid axis; here each block loops over K itself and keeps
// the accumulator in registers (csrc/gemm_core.cuh).
//
// Bound on the card: operations for large square products (8192^3 in bf16
// is ~1.1 TFLOP against ~400 MB), bytes for a thin M (qwen3-14b's gate
// projection over a 256-token prefill chunk, AI 240, sits just left of the
// data sheet's bf16 ridge of ~295).  This first kernel multiplies on the
// CUDA cores in float32, so its own ceiling is the float32 FMA rate, not
// the tensor cores' bf16 rate that bounds the function; tensor cores are
// later work.
//
// Any M, N, K >= 1 (edges are bounds-checked), float32 or bf16 inputs.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int inner_product_launch(x, w, out, M, N, K,
//                            epilogue /*0 none, 1 relu, 2 gelu*/,
//                            dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape, epilogue or dtype the kernel does not take).

#include "gemm_core.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(gemm::kThreads)
    inner_product_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ out, int M, int N, int K,
                         int epilogue) {
  gemm::DenseA<T> a;
  a.p = x;
  a.ld = K;
  gemm::gemm_tile<T, T>(a, w, N, out, N, M, N, K, epilogue);
}

}  // namespace

extern "C" int inner_product_launch(const void* x, const void* w, void* out,
                                    int M, int N, int K, int epilogue,
                                    int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || epilogue < 0 || epilogue > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = gemm::grid_for(M, N, 1);
  if (dtype == 0) {
    inner_product_kernel<float><<<grid, gemm::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N, K, epilogue);
  } else if (dtype == 1) {
    inner_product_kernel<__nv_bfloat16><<<grid, gemm::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, N, K, epilogue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
