// The tiled float32 GEMM core on the CUDA cores, shared by the float32
// paths of the inner product (csrc/inner_product.cu) and of the direct
// convolution as an implicit GEMM (csrc/conv_direct.cu), and by the
// Winograd elementwise stage (csrc/winograd_stage.cu).  Their bf16 paths
// run on the tensor cores (csrc/gemm_wgmma.cuh); float32 stays here, a
// full float32 product as torch.matmul computes it by default (TF32 would
// change the function): every product and sum is an FFMA.
//
//   C[b] (M, N) = epilogue(A[b] (M, K) @ B[b] (K, N)),  b = blockIdx.z
//
// A is read through a loader (a dense row-major matrix here, or the im2col
// view of an NHWC image that the convolution computes on the fly); B is a
// dense row-major (K, N) matrix.  The epilogue (none / relu / tanh-GELU)
// runs on the float32 sum.
//
// What bounds it: at the Winograd stage's ResNet-50 shape (16 products of
// (50176, 128) @ (128, 128)) operations and bytes are within 1.6x of each
// other (26.3 GFLOP, 823 MB), so loads, FMAs and stores must overlap, and
// with K = 128 a tile's ring fill and epilogue weigh; at 4096^3 the K loop
// is everything.
//
// Design:
// * a block of 256 threads computes one 128 x 128 tile of C; thread
//   (tx, ty) = (t % 16, t / 16) owns 8 x 8 outputs as four 4 x 4
//   quadrants, rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns
//   4 tx + {0..3} and 64 + 4 tx + {0..3}: a warp's float4 reads of B cover
//   256 contiguous bytes (no bank conflict), its A reads are two addresses
//   broadcast to 16 threads each, and its float4 stores of a C row cover
//   two contiguous 256-byte runs.  64 accumulators and the fragments fit
//   the 128 registers that two blocks an SM leave a thread;
// * K is staged BK = 32 at a time in a ring of 2 stages in dynamic shared
//   memory (68 KB, two blocks an SM), filled by `cp.async` and waited on
//   with wait_group, one __syncthreads a slab: the next slab's copies are
//   in flight while the block multiplies this one (2048 FFMA a thread, far
//   longer than a load's latency).  On the H100 this ring beat 3 stages of
//   32 and 4 of 16 at the Winograd shape and the direct conv, and tied at
//   4096^3 (PERF.md, the float32 core);
// * A stays as it lies, row-major (As[m][k], rows padded to BK + 4 floats
//   so the two rows a warp reads sit in different banks): its 16-byte
//   copies run along k, and a thread reads 4 k of each of its 8 rows as
//   one float4, then multiplies them by 4 rows of B (8 floats each); B
//   lands as it lies, (K, N) row-major.  The transposed layout would need
//   the copies staged through registers;
// * producers, chosen per operand by the launch: 16-byte `cp.async.cg`
//   copies (kVec: rows of a multiple of 4 floats from a 16-byte aligned
//   base; the convolution's A when Cin % 4 == 0, 4 channels of one pixel
//   and tap), or one 4-byte `cp.async` per element (kElement: any shape
//   and alignment).  A copy outside the operand (past M, N or K, or in
//   the convolution's padding) writes zeros (source size 0), so ragged
//   edges need no other check in the K loop;
// * each output sums k = 0 .. K-1 in order with fmaf, starting from 0, so
//   the result does not depend on the launch (tile, batch index, ragged
//   edge or producer): no split-K, no reordering
//   across threads.  At 4096^3 and at the Winograd shape above, cuBLAS
//   sums the same way: torch.matmul / torch.bmm equal the kernel bit for
//   bit there;
// * the epilogue stores float4 where C's rows allow it (N % 4 == 0,
//   16-byte aligned), else bounds-checked scalars.
// Offsets are 64-bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "gelu_math.cuh"

namespace gemm {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kStages = 2;
constexpr int kMinBlocks = 2;             // an SM, for __launch_bounds__
constexpr int kThreads = 256;             // 8 x 8 outputs each
constexpr int kTx = 16;                   // threads along a row of C
constexpr int kHalf = 64;                 // rows, and columns, between a
                                          // thread's quadrants
constexpr int kAStride = BK + 4;          // floats per A row in a stage
constexpr int kAFloats = BM * kAStride;
constexpr int kStageFloats = kAFloats + BK * BN;
constexpr int kSmemBytes = kStages * kStageFloats * 4;
static_assert(BK % 4 == 0 && kStages >= 2, "slab of whole float4s, a ring");
static_assert(kThreads * 64 == BM * BN && kTx * 8 == BN &&
              2 * kHalf == BM && BM == BN, "8 x 8 outputs a thread");

enum Epilogue { kNone = 0, kRelu = 1, kGelu = 2 };
// an operand's producer: 16-byte copies (4 floats) or one per element
enum Producer { kVec = 0, kElement = 1 };

// The float32 plan code of the C *_plan functions: -2 - (A | B << 1), A
// and B each kVec or kElement (kernels/inner_product.py::describe_plan).
constexpr int plan_code(int a, int b) { return -2 - (a | b << 1); }

// kVec for an operand (or C) whose rows of `row` floats start 16-byte
// aligned (row % 4 == 0 from a 16-byte aligned base), else kElement.
inline int producer(const void* p, int row) {
  return row % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0
             ? kVec : kElement;
}

// Where thread t's j-th copy of W floats lands in a slab of kCols floats
// a row: copies walk the slab row-major, thread index fastest.
template <int W, int kRows, int kCols>
struct Slots {
  static constexpr int kPerRow = kCols / W;
  static constexpr int kRowStep = kThreads / kPerRow;
  static constexpr int kCopies = kRows * kPerRow / kThreads;  // a thread
  static_assert(kThreads % kPerRow == 0 && kCopies * kThreads ==
                kRows * kPerRow, "copies tile the slab");
  __device__ static int row(int t, int j) {
    return t / kPerRow + j * kRowStep;
  }
  __device__ static int col(int t) { return W * (t % kPerRow); }
};

template <int W>
__device__ __forceinline__ void copy(float* dst, const float* src,
                                     bool valid) {
  if constexpr (W == 4) {
    cp_async::copy16_zfill(dst, src, valid);
  } else {
    cp_async::copy4_zfill(dst, src, valid);
  }
}

// A as a dense row-major (M, K) matrix with leading dimension ld (a
// multiple of 4 for W = 4).
template <int W>
struct DenseA {
  using S = Slots<W, BM, BK>;
  const float* __restrict__ p;
  int64_t ld;
  int M, K;
  int m0;

  __device__ __forceinline__ void set_tile(int m) { m0 = m; }
  __device__ __forceinline__ void fill(float* as, int k0) const {
    const int t = threadIdx.x, c = S::col(t), k = k0 + c;
#pragma unroll
    for (int j = 0; j < S::kCopies; ++j) {
      const int r = S::row(t, j), m = m0 + r;
      const bool ok = m < M && k < K;
      copy<W>(as + r * kAStride + c, ok ? p + m * ld + k : p, ok);
    }
  }
};

// B as a dense row-major (K, N) matrix with leading dimension ld (a
// multiple of 4 for W = 4).
template <int W>
struct DenseB {
  using S = Slots<W, BK, BN>;
  const float* __restrict__ p;
  int64_t ld;
  int K, N;
  int n0;

  __device__ __forceinline__ void set_tile(int n) { n0 = n; }
  __device__ __forceinline__ void fill(float* bs, int k0) const {
    const int t = threadIdx.x, c = S::col(t), n = n0 + c;
#pragma unroll
    for (int j = 0; j < S::kCopies; ++j) {
      const int r = S::row(t, j), k = k0 + r;
      const bool ok = k < K && n < N;
      copy<W>(bs + r * BN + c, ok ? p + k * ld + n : p, ok);
    }
  }
};

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One 128 x 128 tile of C (blockIdx.x, blockIdx.y) through the ring.
// vec_c: C's rows take float4 stores (ldc and N multiples of 4, C 16-byte
// aligned).
template <class ALoad, class BLoad>
__device__ __forceinline__ void gemm_tile(ALoad a, BLoad b,
                                          float* __restrict__ C, int64_t ldc,
                                          int M, int N, int K, int epilogue,
                                          bool vec_c) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  a.set_tile(m0);
  b.set_tile(n0);
  const int nk = (K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {     // fill the ring
    if (s < nk) {
      a.fill(smem + s * kStageFloats, s * BK);
      b.fill(smem + s * kStageFloats + kAFloats, s * BK);
    }
    cp_async::commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int stage = 0;                               // the slab multiplied now
  for (int kt = 0; kt < nk; ++kt) {
    // slab kt has landed, and every thread is done with slab kt - 1,
    // whose stage the next copies overwrite
    cp_async::wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) {
      const int s = stage == 0 ? kStages - 1 : stage - 1;
      a.fill(smem + s * kStageFloats, next * BK);
      b.fill(smem + s * kStageFloats + kAFloats, next * BK);
    }
    cp_async::commit();

    const float* as = smem + stage * kStageFloats + 4 * ty * kAStride;
    const float* bs = smem + stage * kStageFloats + kAFloats + 4 * tx;
#pragma unroll
    for (int kg = 0; kg < BK; kg += 4) {
      float4 av[8];                            // rows i, k = kg .. kg + 3
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(as + i * kAStride + kg);
        av[4 + i] = *reinterpret_cast<const float4*>(
            as + (kHalf + i) * kAStride + kg);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[8];                           // row kg + kk of B, its columns
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 b4 = *reinterpret_cast<const float4*>(
              bs + (kg + kk) * BN + q * kHalf);
          bv[4 * q] = b4.x;
          bv[4 * q + 1] = b4.y;
          bv[4 * q + 2] = b4.z;
          bv[4 * q + 3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = lane(av[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }
  cp_async::wait<0>();                         // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : kHalf + 4 * ty + i - 4);
    if (m >= M) continue;
    float* row = C + m * ldc;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + q * kHalf + 4 * tx;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][4 * q + e];
        if (epilogue == kRelu) {
          v[e] = fmaxf(v[e], 0.0f);
        } else if (epilogue == kGelu) {
          v[e] = gelu_f32(v[e]);
        }
      }
      if (vec_c && n < N) {
        *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = v[e];
      }
    }
  }
}

inline dim3 grid_for(int M, int N, int batch) {
  return dim3((M + BM - 1) / BM, (N + BN - 1) / BN, batch);
}

// Launch a core kernel over (M, N) tiles x batch with the ring's dynamic
// shared memory; returns cudaGetLastError() after the launch.
template <class Kernel, class... Args>
inline int launch(Kernel kernel, int M, int N, int batch, cudaStream_t s,
                  Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid_for(M, N, batch), kThreads, kSmemBytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
struct Width {
  static constexpr int value = W;
};

// f(Width<A's copy width>, Width<B's>) for the producers a, b (kVec: 4
// floats a copy, kElement: 1): one kernel instantiation per pair.
template <class F>
inline int with_widths(int a, int b, F f) {
  if (a == kVec) return b == kVec ? f(Width<4>{}, Width<4>{})
                                  : f(Width<4>{}, Width<1>{});
  return b == kVec ? f(Width<1>{}, Width<4>{}) : f(Width<1>{}, Width<1>{});
}

}  // namespace gemm
