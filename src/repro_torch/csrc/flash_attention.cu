// Full-sequence GQA flash attention for Hopper (sm_90a), causal or not.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py: for query head h of batch b
//   o = softmax(scale * q k^T, masked) v   over k / v of KV head h / G,
// with scale = 1 / sqrt(hd) folded into q (float32) before the product,
// the top-left causal mask q_pos >= k_pos (both counted from 0), the
// online softmax (running max m, sum l, accumulator acc, all float32,
// masked scores -1e30), slabs past the query tile skipped when causal,
// acc / max(l, 1e-30) rounded once to q's dtype.
//
// Bound on the card: operations at the sequence lengths it is built for
// (4 hd FLOPs per visible (query, key) pair against q, k, v and o moved
// once: ~S / 2 FLOP a byte causal in bf16).  The Pallas kernel keeps a KV
// head's whole K / V stream in VMEM (2 MB each at S 8192, hd 128, bf16);
// an SM has 227 KB, so here the K / V stream is walked in slabs:
// * one block of 256 threads per (query tile of 64 rows, head, batch);
//   the tile's q (scaled, float32) stays in shared memory;
// * per slab of 64 keys: K and V staged in shared memory as float32,
//   scores S = q k^T as 4 x 4 register tiles per thread (rows 4 ty..,
//   columns tx + 16 c, so neighbouring threads read rows hd + 4 floats apart:
//   no bank conflicts), the online-softmax update of each row by shuffles
//   across the 16 threads that share it, then P (64 x 64, written over
//   the K slab) times V into each thread's 4 x (hd / 16) accumulator;
// * causal blocks skip the slabs after their last row and mask the
//   diagonal slab; ragged ends (S not a multiple of 64) are zero-filled
//   and masked; causal tiles are scheduled longest first.
// The products run on the CUDA cores in float32 (fused multiply-adds
// along hd and along the slab), as the Pallas kernel's f32 dots do; the
// tensor cores (mma.sync / wgmma), cp.async / TMA slab rings and sharing
// one staged slab across the G heads of a KV head are the open levers.
// Every tensor is addressed through (batch, head, sequence) strides with a
// contiguous head dimension, so the model layout (B, S, H, hd) needs no
// transposed copy.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int flash_attention_launch(q, k, v, o, B, H, KV, Sq, Sk, hd,
//       strides /* 12 int64: q, k, v, o each (batch, head, seq) */,
//       scale, causal, dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;             // 16 x 16: (ty, tx)
constexpr float kNegInf = -1e30f;
constexpr int kPStride = kBK + 4;

struct Strides {
  int64_t b, h, s;
};

template <int HD>
struct Layout {
  static constexpr int kQStride = HD + 4;  // floats; rows 16 B aligned
  static constexpr int kKStride = HD + 4;
  static constexpr int kVStride = HD;
  static constexpr int kQ = kBQ * kQStride;
  static constexpr int kK = kBK * kKStride;   // also holds P (64 x 68)
  static constexpr int kV = kBK * kVStride;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV);
  static_assert(kK >= kBQ * kPStride, "P is written over the K slab");
};

// Stage rows [row0, row0 + rows_max) of one head (row stride `ss`) as
// float32 into dst (row stride `ds`), times `mul`; rows at or past `n`
// are zero.  16-byte loads, neighbouring threads on neighbouring chunks.
template <typename T, int HD>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t ss,
                                      int row0, int n, int rows_max,
                                      float* dst, int ds, float mul) {
  constexpr int V = dtype_io::vec16<T>();
  constexpr int kChunks = HD / V;
  for (int e = threadIdx.x; e < rows_max * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * V;
    float v[V];
    if (row0 + r < n) {
      dtype_io::load16(src + (row0 + r) * ss + c, v);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < V; u += 4) {
      *reinterpret_cast<float4*>(dst + r * ds + c + u) =
          make_float4(v[u] * mul, v[u + 1] * mul, v[u + 2] * mul,
                      v[u + 3] * mul);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int G,
                 int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                 Strides os, float scale, int causal) {
  using L = Layout<HD>;
  constexpr int kCols = HD / 16;          // accumulator columns per thread
  constexpr int kColVecs = kCols / 4;     // float4 groups, 64 apart
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + L::kQ;
  float* v_s = k_s + L::kK;
  float* p_s = k_s;

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  // causal tiles run longest (last) first
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q0 = qt * kBQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  const T* qh = q + b * qs.b + h * qs.h;
  const T* kh = k + b * ks.b + kvh * ks.h;
  const T* vh = v + b * vs.b + kvh * vs.h;
  stage<T, HD>(qh, qs.s, q0, Sq, kBQ, q_s, L::kQStride, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  const int n_kb = (Sk + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, Sq) - 1;
  const int n_active = causal ? min(last_row / kBK + 1, n_kb) : n_kb;
  for (int kb = 0; kb < n_active; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();                      // previous slab's P and V read
    stage<T, HD>(kh, ks.s, k0, Sk, kBK, k_s, L::kKStride, 1.0f);
    stage<T, HD>(vh, vs.s, k0, Sk, kBK, v_s, L::kVStride, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kv4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[r] = *reinterpret_cast<const float4*>(
            q_s + (4 * ty + r) * L::kQStride + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv4[c] = *reinterpret_cast<const float4*>(
            k_s + (tx + 16 * c) * L::kKStride + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r].x, kv4[c].x, s[r][c]);
          s[r][c] = fmaf(qa[r].y, kv4[c].y, s[r][c]);
          s[r][c] = fmaf(qa[r].z, kv4[c].z, s[r][c]);
          s[r][c] = fmaf(qa[r].w, kv4[c].w, s[r][c]);
        }
    }

    // mask, then the online-softmax update of each of the 4 rows
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + 4 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        if (kpos >= Sk || (causal && qpos < kpos)) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();                      // every thread is done with K
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p_s[(4 * ty + r) * kPStride + tx + 16 * c] = s[r][c];
    __syncthreads();

    // acc += P V over the slab
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[r] = *reinterpret_cast<const float4*>(
            p_s + (4 * ty + r) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vb[kColVecs];
#pragma unroll
        for (int cv = 0; cv < kColVecs; ++cv)
          vb[cv] = *reinterpret_cast<const float4*>(
              v_s + (j + jj) * L::kVStride + 4 * tx + 64 * cv);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = jj == 0 ? pa[r].x
                          : jj == 1 ? pa[r].y
                          : jj == 2 ? pa[r].z
                                    : pa[r].w;
#pragma unroll
          for (int cv = 0; cv < kColVecs; ++cv) {
            acc[r][4 * cv + 0] = fmaf(p, vb[cv].x, acc[r][4 * cv + 0]);
            acc[r][4 * cv + 1] = fmaf(p, vb[cv].y, acc[r][4 * cv + 1]);
            acc[r][4 * cv + 2] = fmaf(p, vb[cv].z, acc[r][4 * cv + 2]);
            acc[r][4 * cv + 3] = fmaf(p, vb[cv].w, acc[r][4 * cv + 3]);
          }
        }
      }
    }
  }

  T* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cv = 0; cv < kColVecs; ++cv) {
      T* dst = oh + row * os.s + 4 * tx + 64 * cv;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dtype_io::store(dst + e, acc[r][4 * cv + e] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, const int64_t* st,
                   float scale, int causal, cudaStream_t s) {
  auto kernel = flash_kernel<T, HD>;
  const size_t smem = Layout<HD>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KV, Sq, Sk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int H, int KV, int Sq, int Sk, int hd,
                      const int64_t* st, float scale, int causal,
                      cudaStream_t s) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, s);
  if (hd == 128)
    return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal,
                          s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int Sq, int Sk, int hd,
                                      const long long* strides, float scale,
                                      int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = reinterpret_cast<const int64_t*>(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch_hd<float>(q, k, v, o, B, H, KV, Sq, Sk, hd, st, scale, causal,
                         s);
  } else if (dtype == 1) {
    e = launch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, hd, st, scale,
                                 causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
