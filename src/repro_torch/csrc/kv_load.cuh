// Loads of paged KV lines for the paged-attention kernels (GQA and MLA,
// decode and verify): a line stored in the model dtype (float32 / bf16),
// or quantized as int8 or fp8 e4m3 codes with one float32 scale per line
// (src/repro_torch/kernels/quantize.py), widened to float32.  The
// single-walk kernels read the pools in global memory (read-only `__ldg`
// loads, the default); the ring kernels read the same bytes from a ring
// stage in shared memory (SMEM = true: plain loads), so both widen and
// scale with the same instructions.  A quantized element dequantizes as float(code) * scale before
// any score arithmetic, the op order of the Pallas kernels' scale branches
// (`k * ks_ref[...]` ahead of `q @ k.T`), so a kernel and its plain
// version see the same float32 values.  int8 -> float and e4m3 -> half ->
// float are exact conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace kv_load {

// storage codes of the C interfaces: the query's dtype, int8, fp8 e4m3
enum Store : int { kSame = 0, kInt8 = 1, kFp8 = 2 };

template <typename S> struct Quantized {
  static constexpr bool value = false;
};
template <> struct Quantized<int8_t> { static constexpr bool value = true; };
template <> struct Quantized<__nv_fp8_e4m3> {
  static constexpr bool value = true;
};

// elements of a line the MLA kernels stage per load: 16 bytes of the model
// dtype, 8 bytes of codes (the narrowest rope line, dr 8, is one load)
template <typename S> struct StageVec;
template <> struct StageVec<float> { static constexpr int N = 4; };
template <> struct StageVec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct StageVec<int8_t> { static constexpr int N = 8; };
template <> struct StageVec<__nv_fp8_e4m3> { static constexpr int N = 8; };

// One 4-, 8- or 16-byte load: read-only global, or shared memory.
template <bool SMEM, typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (SMEM) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Widen the N elements at p (aligned to N * sizeof element) to float.
template <int N, bool SMEM = false>
__device__ __forceinline__ void widen(const float* p, float* out) {
  static_assert(N % 4 == 0, "float loads are 16 bytes");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 r = load<SMEM>(reinterpret_cast<const float4*>(p + i));
    out[i] = r.x; out[i + 1] = r.y; out[i + 2] = r.z; out[i + 3] = r.w;
  }
}

// bf16: 16-byte loads, or one 8-byte load for N = 4 (the MLA ring's
// float4 slots)
template <int N, bool SMEM = false>
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* out) {
  static_assert(N == 4 || N % 8 == 0, "bf16 loads are 8 or 16 bytes");
  if constexpr (N == 4) {
    const uint2 r = load<SMEM>(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 r = load<SMEM>(reinterpret_cast<const uint4*>(p + i));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        out[i + 2 * j] = f.x;
        out[i + 2 * j + 1] = f.y;
      }
    }
  }
}

// four codes packed in a 32-bit word, lowest byte first
__device__ __forceinline__ void widen4(uint32_t w, const int8_t*, float* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = static_cast<float>(static_cast<int8_t>((w >> (8 * j)) & 0xff));
}

__device__ __forceinline__ void widen4(uint32_t w, const __nv_fp8_e4m3*,
                                       float* out) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    // e4m3 pair -> half pair: the low byte becomes .x
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>((w >> (16 * j)) & 0xffff),
        __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

template <int N, bool SMEM, typename S>
__device__ __forceinline__ void widen_codes(const S* p, float* out) {
  static_assert(N == 4 || N % 8 == 0, "codes load as 4 or 8 bytes");
  if constexpr (N == 4) {
    widen4(load<SMEM>(reinterpret_cast<const uint32_t*>(p)), p, out);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint2 r = load<SMEM>(reinterpret_cast<const uint2*>(p + i));
      widen4(r.x, p, out + i);
      widen4(r.y, p, out + i + 4);
    }
  }
}

template <int N, bool SMEM = false>
__device__ __forceinline__ void widen(const int8_t* p, float* out) {
  widen_codes<N, SMEM>(p, out);
}

template <int N, bool SMEM = false>
__device__ __forceinline__ void widen(const __nv_fp8_e4m3* p, float* out) {
  widen_codes<N, SMEM>(p, out);
}

// N elements of a line at p as float32: widened, and times the line's
// scale when S is a quantized storage type (scale unread otherwise); p in
// shared memory when SMEM
template <int N, bool SMEM = false, typename S>
__device__ __forceinline__ void load_line(const S* p, float scale,
                                          float* out) {
  widen<N, SMEM>(p, out);
  if constexpr (Quantized<S>::value) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = out[i] * scale;
  }
}

// the scale of line `idx` of a scale pool, or 1 for an unquantized pool
// (whose scale pointer is null)
template <typename S>
__device__ __forceinline__ float line_scale(const float* scales,
                                            size_t idx) {
  if constexpr (Quantized<S>::value) return __ldg(scales + idx);
  return 1.f;
}

}  // namespace kv_load
