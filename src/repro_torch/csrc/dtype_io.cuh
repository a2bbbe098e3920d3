// float32 / bf16 element access shared by the LayerNorm, pooling and
// flash-attention kernels: every value is widened to float32 on load and
// rounded once (round to nearest even) on store.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dtype_io {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

// elements of T in one 16-byte access
template <typename T>
__host__ __device__ constexpr int vec16() {
  return 16 / static_cast<int>(sizeof(T));
}

// Widen the vec16<T>() elements of a 16-byte chunk at p (16-byte aligned).
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < vec16<T>(); ++u) out[u] = to_f32(e[u]);
}

// Round and write vec16<T>() values as one 16-byte chunk at p (aligned).
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int u = 0; u < vec16<T>(); ++u) e[u] = from_f32(in[u], T());
  *reinterpret_cast<uint4*>(p) = raw;
}

}  // namespace dtype_io
