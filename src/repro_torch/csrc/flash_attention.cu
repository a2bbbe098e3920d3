// Full-sequence GQA flash attention for Hopper (sm_90a), causal or not.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at :78): for query
// head h of batch b
//   o = softmax(scale * q k^T, masked) v   over k / v of KV head h / G,
// with scale = 1 / sqrt(hd), the top-left causal mask q_pos >= k_pos (both
// counted from 0, also when Sq != Sk), the online softmax (running max m,
// sum l, accumulator acc, all float32, masked scores -1e30), slabs past the
// query tile skipped when causal, acc / max(l, 1e-30) rounded once to q's
// dtype.
//
// Bound on the card: operations at the sequence lengths it is built for
// (4 hd FLOPs per visible (query, key) pair against q, k, v and o moved
// once: ~S / 2 FLOP a byte causal in bf16).  The Pallas kernel keeps a KV
// head's whole K / V stream in VMEM (2 MB each at S 8192, hd 128, bf16);
// an SM has 227 KB, so here the K / V stream is walked in slabs.
//
// bf16 runs on the tensor cores (sm_90a only: wgmma, setmaxnreg), one
// block of three warpgroups per (query tile of 128 rows, head, batch):
// * warpgroup 0 produces: one thread issues TMA copies through 4-D tensor
//   maps (hd, sequence, head, batch) over the tensors' own strides, so the
//   model layout needs no copy, and rows past Sq or Sk arrive as zeros.
//   The query tile comes once (128 x hd); K and V slabs of 128 keys go
//   through a ring of kStages = 2 stages, each with a `full` mbarrier for
//   K, one for V and an `empty` one.  Every operand lies in the 128-byte
//   swizzle in atoms of 64 columns (csrc/gemm_wgmma.cuh's layout): at hd
//   128 a tile is 32 KB, the block's shared memory 161 KB;
// * warpgroups 1 and 2 each own 64 query rows (setmaxnreg 40 / 232).  Per
//   slab: S = Q K^T by wgmma m64n128k16 from shared memory, both operands
//   K-major (hd / 16 steps); the scale times log2(e) on the float32
//   scores, then the causal and ragged-end mask (-1e30) on the slabs that
//   need one; the online softmax in registers on the accumulator
//   fragment: a row's 128 scores lie in the 4 threads of a quad, 32
//   each, so its max takes two __shfl_xor; p = exp2f(x - m) and
//   alpha = exp2f(m_old - m), x and m in units of log2 (exp2f is CUDA's
//   float32 exp2, within 2 ulp; exp(s) = exp2(s log2(e))); l is summed per
//   thread and over the quad once, at the end; O is rescaled by alpha;
//   then O += P V by wgmma m64n<hd>k16 with A from registers: the score
//   fragment's k16 column chunks are already the A operand's register
//   layout once packed into bf16 pairs, and B is the V slab, (keys, hd)
//   with hd contiguous, read transposed by the descriptor.  P goes in as
//   two bf16 parts, p_hi = bf16(p) and p_lo = bf16(p - p_hi), two wgmmas
//   into the same O: p keeps ~2^-18 of relative error where one bf16
//   rounding would leave 2^-9 (the reference multiplies p v in float32),
//   for 1.5x the tensor work the bound counts.  FLASH_P_PARTS=1 builds the
//   single-part product for measurement only: the wrapper never loads it.
//   Each consumer warp releases the stage after its P V products;
// * the epilogue divides by max(l, 1e-30), rounds once to bf16 and stores
//   bounds-checked through o's strides;
// * blocks run heads fastest and query tiles slowest, causal tiles longest
//   first, so the G query heads of a KV head run side by side and share
//   its slabs through L2.
// A bf16 call runs this path or its launch fails: there is no fallback.
//
// float32 runs on the CUDA cores in full float32 (no TF32), as the Pallas
// kernel's f32 dots do:
// * one block of 256 threads per (query tile of 64 rows, head, batch);
//   the tile's q (scaled by `scale`, float32) stays in shared memory;
// * per slab of 64 keys: K and V staged in shared memory, scores
//   S = q k^T as 4 x 4 register tiles per thread (rows 4 ty..,
//   columns tx + 16 c, so neighbouring threads read rows hd + 4 floats apart:
//   no bank conflicts), the online-softmax update of each row by shuffles
//   across the 16 threads that share it, then P (64 x 64, written over
//   the K slab) times V into each thread's 4 x (hd / 16) accumulator;
// * causal blocks skip the slabs after their last row and mask the
//   diagonal slab; ragged ends (S not a multiple of 64) are zero-filled
//   and masked; causal tiles are scheduled longest first.
// Every tensor is addressed through (batch, head, sequence) strides with a
// contiguous head dimension.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int flash_attention_launch(q, k, v, o, B, H, KV, Sq, Sk, hd,
//       strides /* 12 int64: q, k, v, o each (batch, head, seq) */,
//       scale, causal, dtype /*0 f32, 1 bf16*/, stream)
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape or dtype it does not take, or a tensor map that cannot be
// encoded);
//   int flash_attention_plan(dtype, hd)
// returns the path a launch takes: hd (64 or 128) for the bf16 wgmma
// kernel, -1 for the float32 CUDA-core kernel, 0 for none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"
#include "gemm_wgmma.cuh"

#ifndef FLASH_P_PARTS
#define FLASH_P_PARTS 2
#endif

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
    flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

// -- bf16 on the tensor cores ------------------------------------------------

namespace fw {

constexpr int BQ = 128;                  // query rows of a block
constexpr int BK = 128;                  // keys of a slab
constexpr int kStages = 2;
constexpr int kThreads = 384;            // producer + two consumer warpgroups
constexpr int kAtom = 128 * 128;         // bytes: 128 rows x 64 bf16 columns
constexpr float kMasked = -1e30f;

template <int HD>
struct Smem {
  static constexpr int kTile = HD / 64 * kAtom;  // Q tile, K or V slab
  // Q, the K ring, the V ring, then the barriers (q_full, k_full[S],
  // v_full[S], empty[S]); 1 KB to align the base to the swizzle
  static constexpr int kBytes =
      (1 + 2 * kStages) * kTile + 8 * (1 + 3 * kStages) + 1024;
};

// TMA: the box at (c0 = column, c1 = row, c2 = head, c3 = batch) of a 4-D
// map to `dst`, counted as bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(wg::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(wg::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

#define FW_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FW_D16(i) FW_D4(i), FW_D4(i + 4), FW_D4(i + 8), FW_D4(i + 12)

// s (64 x 128, this warpgroup) = (accumulate ? s : 0) + Q (64 x 16) K^T
// (16 x 128): both K-major in shared memory (imm-trans-b 0).
__device__ __forceinline__ void mma_qk(float (&d)[64], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FW_D16(0), FW_D16(16), FW_D16(32), FW_D16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef FW_D16
#undef FW_D4

// One block: query tile blockIdx.z (reversed when causal) of head
// blockIdx.x, batch blockIdx.y.  PARTS: 2 for P as bf16 hi + lo, 1 for P
// rounded once to bf16 (measurement build only).
template <int HD, int PARTS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      __nv_bfloat16* __restrict__ o, int G, int Sq, int Sk,
                      Strides os, float scale_log2, int causal) {
  using L = Smem<HD>;
  constexpr int kAcc = HD / 2;            // O sums per consumer thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* k_ring = q_s + L::kTile;
  uint8_t* v_ring = k_ring + kStages * L::kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_ring + kStages * L::kTile);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int h = blockIdx.x, b = blockIdx.y, kvh = h / G;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.z)
                        : static_cast<int>(blockIdx.z);
  const int q0 = qt * BQ;
  const int n_kb = (Sk + BK - 1) / BK;
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int n_active = causal ? min(last_row / BK + 1, n_kb) : n_kb;

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&k_full[s], 1);
      wg::mbar_init(&v_full[s], 1);
      wg::mbar_init(&empty[s], 8);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    wg::mbar_arrive_expect_tx(q_full, L::kTile);
#pragma unroll
    for (int j = 0; j < HD / 64; ++j)
      tma_load_4d(q_s + j * kAtom, &map_q, q_full, 64 * j, q0, h, b);
    for (int kb = 0; kb < n_active; ++kb) {
      const int s = kb % kStages;
      wg::mbar_wait(&empty[s], ((kb / kStages) & 1) ^ 1);  // fresh: passes
      uint8_t* ks = k_ring + s * L::kTile;
      uint8_t* vs = v_ring + s * L::kTile;
      wg::mbar_arrive_expect_tx(&k_full[s], L::kTile);
#pragma unroll
      for (int j = 0; j < HD / 64; ++j)
        tma_load_4d(ks + j * kAtom, &map_k, &k_full[s], 64 * j, kb * BK, kvh,
                    b);
      wg::mbar_arrive_expect_tx(&v_full[s], L::kTile);
#pragma unroll
      for (int j = 0; j < HD / 64; ++j)
        tma_load_4d(vs + j * kAtom, &map_v, &v_full[s], 64 * j, kb * BK, kvh,
                    b);
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 (wgi - 1) .. of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wgi - 1;
  const int tt = threadIdx.x % 128, lane = tt % 32;
  // accumulator layout of m64nN: for n8 block j, thread tt holds rows
  // 16 (tt / 32) + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4) (+ 1)
  const int row0 = q0 + 64 * c + 16 * (tt / 32) + lane / 4;
  const int col = 2 * (lane % 4);
  const int first_row = q0 + 64 * c;
  const uint32_t q_addr = wg::smem_u32(q_s) + c * 64 * 128;
  const uint32_t k_addr = wg::smem_u32(k_ring);
  const uint32_t v_addr = wg::smem_u32(v_ring);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  wg::mbar_wait(q_full, 0);

  for (int kb = 0; kb < n_active; ++kb) {
    const int s = kb % kStages;
    const uint32_t parity = (kb / kStages) & 1;
    const int k0 = kb * BK;

    // S = Q K^T (float32 sums of bf16 products)
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    wg::mbar_wait(&k_full[s], parity);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
      mma_qk(sc, wg::sw128_desc(q_addr + off, 0, 1024),
             wg::sw128_desc(k_addr + s * L::kTile + off, 0, 1024), kk > 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::pin(sc);

    // scale (in units of log2), mask, row max over the quad
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > first_row);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * hh + e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + col + e;
            if (key >= Sk || (causal && row0 + 8 * hh < key)) x = kMasked;
          }
          sc[4 * j + 2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = exp2f(m[hh] - mx[hh]);
      m[hh] = mx[hh];
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * hh + e] - m[hh]);
          sc[4 * j + 2 * hh + e] = p;
          sum[hh] += p;
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + sum[hh];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        acc[4 * j + 2 * hh] *= alpha[hh];
        acc[4 * j + 2 * hh + 1] *= alpha[hh];
      }
    }

    // P as A fragments: register 4 cc + r of key chunk cc holds the pair
    // (sc[8 cc + 2 r], sc[8 cc + 2 r + 1]): rows lane / 4 (r even) or + 8
    // (r odd), keys 16 cc + 2 (lane % 4) (+ 8 for r >= 2)
    uint32_t p_hi[32], p_lo[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float a0 = sc[2 * i], a1 = sc[2 * i + 1];
      p_hi[i] = wg::bf16x2(a0, a1);
      if constexpr (PARTS == 2) {
        const float h0 = __uint_as_float(p_hi[i] << 16);
        const float h1 = __uint_as_float(p_hi[i] & 0xffff0000u);
        p_lo[i] = wg::bf16x2(a0 - h0, a1 - h1);   // both differences exact
      }
    }

    // O += P V
    wg::mbar_wait(&v_full[s], parity);
    wg::wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < BK / 16; ++cc) {
      const uint64_t dv = wg::sw128_desc(
          v_addr + s * L::kTile + cc * 16 * 128, kAtom, 1024);
      wg::MmaRegA<HD>::run(acc, &p_hi[4 * cc], dv);
      if constexpr (PARTS == 2) wg::MmaRegA<HD>::run(acc, &p_lo[4 * cc], dv);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::pin(acc);
    wg::pin_u32(p_hi);
    if constexpr (PARTS == 2) wg::pin_u32(p_lo);
    if (lane == 0) wg::mbar_arrive(&empty[s]);
  }

  // l over the quad, then acc / max(l, 1e-30) rounded once to bf16
  __nv_bfloat16* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row0 + 8 * hh;
    if (row >= Sq) continue;
    const float den = fmaxf(lt, 1e-30f);
    __nv_bfloat16* dst = oh + row * os.s + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] / den,
                                acc[4 * j + 2 * hh + 1] / den);
  }
}

// Map of one (batch, head, sequence, hd) bf16 tensor with element strides
// st = (batch, head, sequence), hd contiguous: dimensions (hd, seq, head,
// batch), boxes of 64 columns x 128 rows, 128-byte swizzle, zeros outside.
// Needs a 16-byte aligned base and strides (the wrapper checks both).
inline bool make_map(CUtensorMap* map, const void* base, int hd, int seq,
                     int heads, int batch, const int64_t* st) {
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, BK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, const int64_t* st,
                   float scale, int causal, cudaStream_t s) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap mq = {}, mk = {}, mv = {};
  if (!make_map(&mq, q, HD, Sq, H, B, st) ||
      !make_map(&mk, k, HD, Sk, KV, B, st + 3) ||
      !make_map(&mv, v, HD, Sk, KV, B, st + 6))
    return cudaErrorInvalidValue;
  auto kernel = flash_bf16_kernel<HD, FLASH_P_PARTS>;
  const int smem = Smem<HD>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(H, B, n_qt);
  kernel<<<grid, kThreads, smem, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H / KV, Sq, Sk,
      Strides{st[9], st[10], st[11]}, scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace fw

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, const int64_t* st,
                   float scale, int causal, cudaStream_t s) {
  auto kernel = flash_f32_kernel<T, HD>;
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

int plan_for(int dtype, int hd) {
  if (hd != 64 && hd != 128) return 0;
  return dtype == 0 ? -1 : dtype == 1 ? hd : 0;
}

}  // namespace

extern "C" int flash_attention_plan(int dtype, int hd) {
  return plan_for(dtype, hd);
}

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
  switch (plan_for(dtype, hd)) {
    case -1:
      e = launch_hd<float>(q, k, v, o, B, H, KV, Sq, Sk, hd, st, scale,
                           causal, s);
      break;
    case 64:
      e = fw::launch<64>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, s);
      break;
    case 128:
      e = fw::launch<128>(q, k, v, o, B, H, KV, Sq, Sk, st, scale, causal, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
