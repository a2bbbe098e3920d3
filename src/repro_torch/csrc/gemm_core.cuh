// The tiled GEMM core shared by the inner product (csrc/inner_product.cu),
// the direct convolution as an implicit GEMM (csrc/conv_direct.cu) and the
// Winograd elementwise stage (csrc/winograd_stage.cu).
//
//   C[b] (M, N) = epilogue(A[b] (M, K) @ B[b] (K, N)),  b = blockIdx.z
//
// A is read through a loader (a dense row-major matrix, or the im2col view
// of an NHWC image that the convolution computes on the fly); B is a dense
// row-major (K, N) matrix.  Sums are float32 in registers whatever the
// input type; the epilogue (none / relu / tanh-GELU) runs on the float32
// sum and the result is rounded once to the output type.
//
// Design, kept simple for a first kernel (CUDA cores, no tensor cores):
// * a block of 256 threads computes one 128 x 128 tile of C; each thread
//   an 8 x 8 sub-tile, 64 float32 accumulators in registers;
// * K advances 8 at a time through shared memory: A's 128 x 8 slab stored
//   transposed (As[k][m], so a thread reads its 8 rows as two float4), B's
//   8 x 128 slab as is; every element is widened to float32 on the way in;
// * the next slab is loaded from global memory into registers while the
//   current one is multiplied (one slab of prefetch, no cp.async ring);
// * every load and store is bounds-checked, so M, N and K need not be
//   multiples of any tile (out-of-range A/B elements read as 0);
// * each output sums k = 0 .. K-1 in order with fmaf, so the result does
//   not depend on the launch.
// Offsets are 64-bit.  Tensor cores (mma.sync / wgmma), TMA and cp.async
// rings are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu_math.cuh"

namespace gemm {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);        // 256
constexpr int kALoads = BM * BK / kThreads;            // 4 per thread
constexpr int kBLoads = BK * BN / kThreads;            // 4 per thread
constexpr int kARowStride = kThreads / BK;             // 32
constexpr int kBRowStride = kThreads / BN;             // 2

enum Epilogue { kNone = 0, kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);                 // round to nearest even
}

// A as a dense row-major (M, K) matrix with leading dimension ld.
template <typename T>
struct DenseA {
  const T* __restrict__ p;
  int64_t ld;
  int64_t row[kALoads];
  bool valid[kALoads];

  __device__ __forceinline__ void set_rows(const int* m, int M) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      valid[i] = m[i] < M;
      row[i] = static_cast<int64_t>(m[i]) * ld;
    }
  }
  __device__ __forceinline__ float load(int i, int k, int K) const {
    return (valid[i] && k < K) ? to_f32(p[row[i] + k]) : 0.0f;
  }
};

template <typename T>
__device__ __forceinline__ float load_b(const T* __restrict__ B, int64_t ldb,
                                        int k, int n, int K, int N) {
  return (k < K && n < N) ? to_f32(B[static_cast<int64_t>(k) * ldb + n])
                          : 0.0f;
}

template <typename T, typename OutT, typename ALoader>
__device__ __forceinline__ void gemm_tile(ALoader a, const T* __restrict__ B,
                                          int64_t ldb, OutT* __restrict__ C,
                                          int64_t ldc, int M, int N, int K,
                                          int epilogue) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  // this thread's A slots: rows tid/BK + 32 i of the tile, column tid % BK
  const int a_col = tid % BK;
  int a_rows[kALoads];
#pragma unroll
  for (int i = 0; i < kALoads; ++i)
    a_rows[i] = m0 + tid / BK + i * kARowStride;
  a.set_rows(a_rows, M);
  // its B slots: rows tid/BN + 2 i of the slab, column tid % BN
  const int b_col = n0 + tid % BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float a_next[kALoads], b_next[kBLoads];
#pragma unroll
  for (int i = 0; i < kALoads; ++i) a_next[i] = a.load(i, a_col, K);
#pragma unroll
  for (int i = 0; i < kBLoads; ++i)
    b_next[i] = load_b(B, ldb, tid / BN + i * kBRowStride, b_col, K, N);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i)
      As[a_col][tid / BK + i * kARowStride] = a_next[i];
#pragma unroll
    for (int i = 0; i < kBLoads; ++i)
      Bs[tid / BN + i * kBRowStride][tid % BN] = b_next[i];
    __syncthreads();

    const int k1 = k0 + BK;
    if (k1 < K) {                     // prefetch the next slab
#pragma unroll
      for (int i = 0; i < kALoads; ++i) a_next[i] = a.load(i, k1 + a_col, K);
#pragma unroll
      for (int i = 0; i < kBLoads; ++i)
        b_next[i] =
            load_b(B, ldb, k1 + tid / BN + i * kBRowStride, b_col, K, N);
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float af[TM], bf[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      af[0] = a0.x; af[1] = a0.y; af[2] = a0.z; af[3] = a0.w;
      af[4] = a1.x; af[5] = a1.y; af[6] = a1.z; af[7] = a1.w;
      bf[0] = b0.x; bf[1] = b0.y; bf[2] = b0.z; bf[3] = b0.w;
      bf[4] = b1.x; bf[5] = b1.y; bf[6] = b1.z; bf[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    OutT* row = C + static_cast<int64_t>(m) * ldc;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (epilogue == kRelu) {
        v = fmaxf(v, 0.0f);
      } else if (epilogue == kGelu) {
        v = gelu_f32(v);
      }
      row[n] = from_f32<OutT>(v);
    }
  }
}

inline dim3 grid_for(int M, int N, int batch) {
  return dim3((M + BM - 1) / BM, (N + BN - 1) / BN, batch);
}

}  // namespace gemm
