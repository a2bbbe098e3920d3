// Bandwidth of the card's on-chip level: a cache-resident triad, the
// hierarchical roofline's `vmem` beta (arXiv 2009.05257) on Hopper.
//
// a = a * s + b over two float32 arrays of n floats each, repeated `iters`
// times inside one launch.  The two arrays (2 x n x 4 bytes, sized by the
// caller to sit well inside the 50 MB L2) come from HBM on the first pass
// only; every later pass hits L2.  Loads and stores are `.cg` (cache in L2,
// not L1) and asm volatile, so every pass really reads and writes L2 and
// the compiler keeps no element in registers across passes.  Each thread
// owns the same float4s on every pass, so there is no race and no grid
// sync.  Traffic: 3 x n x 4 bytes a pass (read a, read b, write a).
//
// C interface (bound with ctypes by repro_torch/core/roofline/microbench.py):
//   int l2_probe_launch(a, b, n4, iters, s, blocks, threads, stream)
// a and b hold n4 float4s each, 16-byte aligned; returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 load_cg(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_cg(float4* p, float4 v) {
  asm volatile("st.global.cg.v4.f32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__global__ void l2_triad_kernel(float4* __restrict__ a,
                                const float4* __restrict__ b, long n4,
                                int iters, float s) {
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  const long first = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int it = 0; it < iters; ++it) {
    for (long i = first; i < n4; i += stride) {
      float4 x = load_cg(a + i);
      const float4 y = load_cg(b + i);
      x.x = fmaf(x.x, s, y.x);
      x.y = fmaf(x.y, s, y.y);
      x.z = fmaf(x.z, s, y.z);
      x.w = fmaf(x.w, s, y.w);
      store_cg(a + i, x);
    }
  }
}

}  // namespace

extern "C" int l2_probe_launch(void* a, const void* b, long n4, int iters,
                               float s, int blocks, int threads,
                               void* stream) {
  if (n4 <= 0 || iters <= 0 || blocks <= 0 || threads <= 0 ||
      threads > 1024 || (reinterpret_cast<unsigned long>(a) & 15) ||
      (reinterpret_cast<unsigned long>(b) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  l2_triad_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(a), static_cast<const float4*>(b), n4, iters, s);
  return static_cast<int>(cudaGetLastError());
}
