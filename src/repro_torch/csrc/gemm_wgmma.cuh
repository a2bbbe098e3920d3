// The bf16 GEMM core on Hopper's tensor cores, shared by the inner product
// (csrc/inner_product.cu, replacing the Pallas `inner_product`,
// src/repro/kernels/inner_product.py:52) and the direct convolution as an
// implicit GEMM (csrc/conv_direct.cu, replacing `conv2d_direct`,
// src/repro/kernels/conv_direct.py:49):
//
//   C (M, N) = epilogue(A (M, K) @ B (K, N)),  bf16 in, float32 sum, bf16 out
//
// Bound on the card: operations for large products (989 TFLOP/s bf16 on the
// data sheet, ~786 measured through cuBLAS), bytes for a thin M (qwen3-14b's
// gate projection over 256 tokens reads 178 MB of weights for 46 GFLOP).
// The float32 path and the Winograd stage stay on csrc/gemm_core.cuh.
// Its PTX helpers, descriptors and wgmma wrappers (B from shared memory,
// A from shared memory or, for P, from registers) also serve flash
// attention (csrc/flash_attention.cu) and the MLA core (csrc/mla_core.cuh).
//
// Design (sm_90a only: wgmma, setmaxnreg):
// * a block of three warpgroups computes one BM x BN = 128 x 128 or
//   128 x 256 output tile: warpgroup 0 produces, warpgroups 1 and 2 each
//   multiply 64 rows with `wgmma.mma_async` m64nBNk16 (bf16 x bf16 -> f32),
//   the float32 accumulator in registers (BN / 2 per thread).  At BN 256
//   the 128 sums need the registers the producer does not: ptxas gives
//   168 a thread at launch and setmaxnreg moves them to 40 / 232; a stage
//   is 48 KB, four fit (197 KB).  BN 128 kernels take 90-168 registers
//   and 5 stages of 32 KB (161 KB).  Taller tiles (three or four consumer
//   warpgroups, 192 or 256 rows) were only 5-8% faster on the
//   convolution, and their element-wise producers spilled at 128 / 96
//   registers;
// * K is staged 64 bf16 (128 bytes) at a time in a ring of 4 (BN 256) or 5
//   (BN 128) stages in shared memory, each operand laid out in the 128-byte
//   swizzle that TMA writes and the wgmma descriptors read: A K-major (row
//   m at 128 m bytes), B as it lies in memory, (K, N) row-major, in 64-column
//   atoms of 64 x 128 bytes, which the descriptor reads transposed (no copy
//   of B is made);
// * each stage has a `full` mbarrier (the producer's copies have landed;
//   thread 0 arrives with the TMA bytes, each producer thread that writes
//   the stage once) and an `empty` one (lane 0 of each consumer warp,
//   when its products on the stage are done); the
//   consumers keep one stage's products in flight while they issue the
//   next, so the tensor cores never wait for a release;
// * a stage is filled by one of three producers, chosen per operand by the
//   launch function from the shape and alignment; the consumers are the
//   same for all of them:
//     - TMA (`cp.async.bulk.tensor`, tensor maps encoded on the host): one
//       thread issues a stage; out-of-range rows and columns arrive as 0;
//       needs 16-byte aligned rows (K % 8 == 0 for A, N % 8 == 0 for B);
//     - 16-byte `cp.async` copies by the 128 producer threads (the
//       convolution's im2col rows, csrc/conv_direct.cu), signalled a few
//       stages late, after `cp.async.wait_group` and a proxy fence;
//     - element-wise: bounds-checked 2-byte loads packed into 16-byte
//       shared stores, for any shape and alignment;
// * the epilogue (none / relu / tanh-GELU) runs on the float32 accumulator
//   in registers, rounds once to bf16 and stores bounds-checked;
// * tiles are walked in bands of 16 row tiles, so the blocks of one wave
//   share their rows of A and columns of B in L2 (at a thin M the two row
//   tiles of one column are neighbours: B is read from memory once).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu_math.cuh"

namespace wg {

constexpr int BM = 128;                    // rows of a tile
constexpr int BK = 64;                     // K per stage: one 128-byte row
constexpr int kConsumers = 2;              // warpgroups of 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 16;                // row tiles per band of the walk
constexpr int kAStageBytes = BM * BK * 2;  // 16 KB
constexpr int kAtomBytes = 64 * BK * 2;    // 64 columns of B over one stage

template <int BN> struct Tile {
  static constexpr int kStages = BN == 256 ? 4 : 5;
  static constexpr int kBStageBytes = BK * BN * 2;
  static constexpr int kAcc = BN / 2;      // float32 sums per consumer thread
  // the two rings, then the barriers; 1 KB to align the base to the swizzle
  static constexpr int kSmemBytes =
      kStages * (kAStageBytes + kBStageBytes) + 2 * kStages * 8 + 1024;
};

enum Producer { kTma = 0, kCpAsync = 1, kElement = 2 };
enum Epilogue { kNone = 0, kRelu = 1, kGelu = 2 };

// -- PTX -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// Make this thread's generic-proxy shared stores (st.shared, cp.async)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: copy the box at (c0 = column, c1 = row) of `map` to `dst`, counted
// as bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes from global `src` to shared `dst`, or 16 zero bytes if !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// A K-major: rows of 128 bytes, 8-row groups 1024 bytes apart.  k16 step
// kk of a stage starts 32 kk bytes into each row.
__device__ __forceinline__ uint64_t desc_a(uint32_t a_stage, int kk) {
  return sw128_desc(a_stage + kk * 32, 0, 1024);
}

// B (K, N) row-major, read transposed: 64-column atoms kAtomBytes apart
// (leading), 8 K-rows of 128 bytes a group 1024 bytes apart (stride).  k16
// step kk of a stage starts 16 rows down.
__device__ __forceinline__ uint64_t desc_b(uint32_t b_stage, int kk) {
  return sw128_desc(b_stage + kk * 16 * 128, kAtomBytes, 1024);
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D16(i) WG_D4(i), WG_D4(i + 4), WG_D4(i + 8), WG_D4(i + 12)
#define WG_D64(i) WG_D16(i), WG_D16(i + 16), WG_D16(i + 32), WG_D16(i + 48)

// d (64 x BN, this warpgroup) += A (64 x 16) @ B (16 x BN): bf16 in, f32
// sums; A K-major, B transposed (imm-trans-b 1).
template <int BN> struct Mma;

template <> struct Mma<128> {
  __device__ static __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : WG_D64(0)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Mma<256> {
  __device__ static __forceinline__ void run(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : WG_D64(0), WG_D64(64)
        : "l"(da), "l"(db), "r"(1));
  }
};


// d (64 x N) += A (64 x 16, bf16 pairs in registers) B (16 x N, (k, n)
// row-major in shared memory, read transposed: imm-trans-b 1).  a[r] is
// the bf16 pair (bf16x2) of elements 2 r, 2 r + 1 of a thread's m64n16
// float32 accumulator fragment, so a score tile packs straight into the A
// operand (P in flash attention and in the MLA core).
template <int N> struct MmaRegA;

template <> struct MmaRegA<64> {
  __device__ static __forceinline__ void run(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D16(0), WG_D16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct MmaRegA<128> {
  __device__ static __forceinline__ void run(float (&d)[64], const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
        "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct MmaRegA<256> {
  __device__ static __forceinline__ void run(float (&d)[128],
                                             const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
        "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
        "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
        "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
        "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
        "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
        "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : WG_D64(0), WG_D64(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef WG_D64
#undef WG_D16
#undef WG_D4

// Keep the compiler from moving A-fragment registers across wgmma.
template <int N>
__device__ __forceinline__ void pin_u32(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// (lo, hi) rounded to a bf16 pair in one 32-bit register, lo in the low
// half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- producers ---------------------------------------------------------------
//
// A producer fills one operand of one stage.  TMA producers are called by
// producer thread 0 alone; the others by all 128 producer threads (`pt`).
// Thread-written stages use the TMA's layout: 16-byte chunk c of 128-byte
// row r (relative to a 1024-byte aligned base) lands at chunk c ^ (r % 8).

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | static_cast<uint32_t>(hi) << 16;
}

// A by TMA: the (BM x BK) box at (k0, m0) of a (M, K) row-major map.
struct TmaA {
  static constexpr int kKind = kTma;
  __device__ void issue(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int m0, int k0) const {
    tma_load(dst, map, bar, k0, m0);
  }
};

// B by TMA: BN / 64 boxes of (BK x 64) at (n0 + 64 j, k0) of a (K, N)
// row-major map, one atom each.
template <int BN>
struct TmaB {
  static constexpr int kKind = kTma;
  __device__ void issue(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                        int n0, int k0) const {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load(dst + j * kAtomBytes, map, bar, n0 + 64 * j, k0);
  }
};

// A element-wise through a view of A: thread pt fills chunk c = pt % 8 of
// rows pt / 8 + 16 j, j < R = 8.  View: set_row(j, m) (m may be >= M),
// kinfo(k) -> K, get(j, K) -> raw bf16 bits (0 outside A).
template <class View>
struct ElemA {
  static constexpr int kKind = kElement;
  static constexpr int R = BM / 16;
  View v;
  __device__ void set_tile(int m0, int pt) {
#pragma unroll
    for (int j = 0; j < R; ++j) v.set_row(j, m0 + pt / 8 + 16 * j);
  }
  __device__ void fill(uint8_t* dst, int k0, int pt) const {
    const int c = pt % 8, r0 = pt / 8;
    uint16_t e[R][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const typename View::K kk = v.kinfo(k0 + 8 * c + i);
#pragma unroll
      for (int j = 0; j < R; ++j) e[j][i] = v.get(j, kk);
    }
    const int sw = (c ^ (r0 & 7)) * 16;
#pragma unroll
    for (int j = 0; j < R; ++j)
      *reinterpret_cast<uint4*>(dst + (r0 + 16 * j) * 128 + sw) =
          make_uint4(pack2(e[j][0], e[j][1]), pack2(e[j][2], e[j][3]),
                     pack2(e[j][4], e[j][5]), pack2(e[j][6], e[j][7]));
  }
};

// A dense (M, K) row-major, any K and alignment.
struct DenseView {
  struct K { int k; bool ok; };
  const uint16_t* __restrict__ p;
  int M, Kdim;
  int64_t off[BM / 16];
  bool ok[BM / 16];
  __device__ void set_row(int j, int m) {
    ok[j] = m < M;
    off[j] = static_cast<int64_t>(ok[j] ? m : 0) * Kdim;
  }
  __device__ K kinfo(int k) const { return K{k, k < Kdim}; }
  __device__ uint16_t get(int j, K k) const {
    return (ok[j] && k.ok) ? p[off[j] + k.k] : 0;
  }
};

// B element-wise: (K, N) row-major, any N and alignment.  Thread pt fills
// chunk column cc = pt % (BN / 8) of K-rows pt / (BN / 8) + rows_per j.
template <int BN>
struct ElemB {
  static constexpr int kKind = kElement;
  static constexpr int kChunks = BN / 8;             // per 128-wide row
  static constexpr int kRowsPer = 128 / kChunks;     // per pass
  const uint16_t* __restrict__ p;
  int K, N;
  __device__ void fill(uint8_t* dst, int n0, int k0, int pt) const {
    const int cc = pt % kChunks, r0 = pt / kChunks;
    const int n = n0 + 8 * cc;
    uint8_t* atom = dst + (cc / 8) * kAtomBytes;
#pragma unroll 4
    for (int j = 0; j < BK / kRowsPer; ++j) {
      const int kr = r0 + kRowsPer * j;
      const int k = k0 + kr;
      const int sw = ((cc % 8) ^ (kr & 7)) * 16;
      uint16_t e[8];
      const uint16_t* row = p + static_cast<int64_t>(k) * N;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = (k < K && n + i < N) ? row[n + i] : 0;
      *reinterpret_cast<uint4*>(atom + kr * 128 + sw) =
          make_uint4(pack2(e[0], e[1]), pack2(e[2], e[3]),
                     pack2(e[4], e[5]), pack2(e[6], e[7]));
    }
  }
};

// -- the kernel body ---------------------------------------------------------

struct Out {
  __nv_bfloat16* __restrict__ p;
  int M, N, K;
  int epilogue;
};

// One block: one BM x BN tile of C.  ALoad: TmaA, ElemA<View> or a
// cp.async loader (kKind kCpAsync: set_tile(m0, pt), fill(dst, k0, pt));
// BLoad: TmaB<BN> or ElemB<BN>.
template <int BN, class ALoad, class BLoad>
__device__ __forceinline__ void gemm_block(const CUtensorMap* map_a,
                                           const CUtensorMap* map_b,
                                           ALoad a, const BLoad& b,
                                           const Out& o) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  constexpr bool kTmaA = ALoad::kKind == kTma;
  constexpr bool kTmaB = BLoad::kKind == kTma;
  constexpr bool kCp = ALoad::kKind == kCpAsync;
  constexpr bool kThreadsWrite = !kTmaA || !kTmaB;
  constexpr uint32_t kTx =
      (kTmaA ? kAStageBytes : 0) + (kTmaB ? T::kBStageBytes : 0);
  // cp.async stages are signalled kLag stages after they are issued
  constexpr int kLag = kCp ? S - 2 : 0;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* a_ring = smem;
  uint8_t* b_ring = smem + S * kAStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      b_ring + S * T::kBStageBytes);
  uint64_t* empty = full + S;

  // this block's tile (rows m0, columns n0) in a walk over bands of
  // kGroupM row tiles
  const int tiles_m = (o.M + BM - 1) / BM;
  const int tiles_n = (o.N + BN - 1) / BN;
  const int band = kGroupM * tiles_n;
  const int first_m = (blockIdx.x / band) * kGroupM;
  const int rows_here = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + blockIdx.x % band % rows_here) * BM;
  const int n0 = (blockIdx.x % band / rows_here) * BN;
  const int n_k = (o.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], kThreadsWrite ? 128 + (kTx ? 1 : 0) : 1);
      mbar_init(&empty[s], kConsumers * 4);      // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // ---- producer warpgroup ----
    if constexpr (BN == 256)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x;
    if (!kThreadsWrite && pt != 0) return;
    if constexpr (!kTmaA) a.set_tile(m0, pt);
    int s = 0;
    uint32_t parity = 1;               // a fresh ring starts empty
    for (int i = 0; i < n_k; ++i) {
      const int k0 = i * BK;
      mbar_wait(&empty[s], parity);
      uint8_t* as = a_ring + s * kAStageBytes;
      uint8_t* bs = b_ring + s * T::kBStageBytes;
      if constexpr (kTx != 0) {
        if (pt == 0) {
          mbar_arrive_expect_tx(&full[s], kTx);
          if constexpr (kTmaA) a.issue(as, map_a, &full[s], m0, k0);
          if constexpr (kTmaB) b.issue(bs, map_b, &full[s], n0, k0);
        }
      }
      if constexpr (!kTmaA) a.fill(as, k0, pt);
      if constexpr (!kTmaB) b.fill(bs, n0, k0, pt);
      if constexpr (kCp) {
        cp_async_commit();
        if (i >= kLag) {
          cp_async_wait<kLag>();
          fence_proxy_async();
          mbar_arrive(&full[(i - kLag) % S]);
        }
      } else if constexpr (kThreadsWrite) {
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
      if (++s == S) { s = 0; parity ^= 1; }
    }
    if constexpr (kCp) {
      cp_async_wait<0>();
      fence_proxy_async();
      for (int i = max(0, n_k - kLag); i < n_k; ++i) mbar_arrive(&full[i % S]);
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 (wgi - 1) .. of the tile ----
  if constexpr (BN == 256)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wgi - 1;
  const uint32_t a_base = smem_u32(a_ring) + c * 64 * 128;
  const uint32_t b_base = smem_u32(b_ring);
  const bool lane0 = threadIdx.x % 32 == 0;
  // accumulator layout of m64nBN: for n8 block j, thread tt holds rows
  // 16 (tt / 32) + tt % 32 / 4 (+ 8) and columns 8 j + 2 (tt % 4) (+ 1)
  const int tt = threadIdx.x % 128;
  const int row_in = 64 * c + 16 * (tt / 32) + (tt % 32) / 4;
  const int col_in = 2 * (tt % 4);
  const bool pairs = o.N % 2 == 0;
  float acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.0f;
  int s = 0, prev = 0;
  uint32_t parity = 0;
  for (int i = 0; i < n_k; ++i) {
    mbar_wait(&full[s], parity);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Mma<BN>::run(acc, desc_a(a_base + s * kAStageBytes, kk),
                   desc_b(b_base + s * T::kBStageBytes, kk));
    wgmma_commit();
    wgmma_wait<1>();                   // stage i - 1's products are done
    pin(acc);
    if (i > 0 && lane0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == S) { s = 0; parity ^= 1; }
  }
  wgmma_wait<0>();
  pin(acc);

#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row_in + 8 * h;
      const int n = n0 + col_in + 8 * j;
      if (m >= o.M || n >= o.N) continue;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (o.epilogue == kRelu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      } else if (o.epilogue == kGelu) {
        v0 = gelu_f32(v0);
        v1 = gelu_f32(v1);
      }
      __nv_bfloat16* dst = o.p + static_cast<int64_t>(m) * o.N + n;
      if (pairs) {                     // n even, so 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16(v0);
        if (n + 1 < o.N) dst[1] = __float2bfloat16(v1);
      }
    }
  }
}

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so the library
// needs no -lcuda; null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Map of a (rows, cols) row-major bf16 matrix in boxes of box_rows x 64
// columns (128 bytes), 128-byte swizzle, zeros outside.  Needs cols % 8 ==
// 0 and a 16-byte aligned base.
inline bool make_map(CUtensorMap* map, const void* base, uint64_t rows,
                     uint64_t cols, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

// BN for a product whose stages both come by TMA: 256 unless 128-wide
// tiles finish in less time, counting whole waves of one block per SM
// (qwen3-14b's gate projection, M 256, N 17408: 136 tiles of 256 take two
// waves of 256-wide work, 272 tiles of 128 three waves of half the work).
inline int pick_bn(int M, int N) {
  const int64_t sms = sm_count();
  const int64_t tm = (M + BM - 1) / BM;
  const int64_t w256 = (tm * ((N + 255) / 256) + sms - 1) / sms;
  const int64_t w128 = (tm * ((N + 127) / 128) + sms - 1) / sms;
  return 256 * w256 <= 128 * w128 ? 256 : 128;
}

// Blocks for a (M, N) product: one per BM x BN tile.
inline unsigned grid_for(int M, int N, int BN) {
  return static_cast<unsigned>(((M + BM - 1) / BM) *
                               static_cast<int64_t>((N + BN - 1) / BN));
}

// Code of a plan, as the *_plan C functions return it: the A producer in
// bits 0-1, the B producer in bits 2-3, bit 4 set for BN 256.
inline int plan_code(int a_kind, int b_kind, int bn) {
  return a_kind | b_kind << 2 | (bn == 256 ? 16 : 0);
}

// Launch `kernel`, a block per BM x BN tile of a (M, N) product, on
// `stream` with the tile's dynamic shared memory.
template <int BN, class Kernel, class... Args>
inline int launch(Kernel kernel, int M, int N, cudaStream_t stream,
                  Args... args) {
  const int bytes = Tile<BN>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid_for(M, N, BN), kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
