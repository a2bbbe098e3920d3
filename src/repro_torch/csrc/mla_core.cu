// The MLA latent-attention core on Hopper's tensor cores (sm_90a): the bf16
// path of the three walks that replace the Pallas TPU kernels of
// src/repro/kernels/paged_attention.py, one entry point built once:
// * decode (`mla_paged_attention`, :445; `_mla_paged_decode_kernel`,
//   :353): n_tokens 1, stages 1;
// * multi-token verification (`mla_paged_attention_verify`, :660): stages
//   1;
// * the `pipeline="double"` walk of both (`_mla_paged_double`, :932):
//   stages 2-4.
// Their float32 paths stay on the CUDA cores (csrc/mla_paged_attention.cu,
// csrc/mla_paged_attention_verify.cu, csrc/mla_paged_attention_ring.cu);
// the wrappers in repro_torch/kernels/paged_attention.py pick the source by
// the queries' dtype.
// For slot b, query token t (T = 1 for decode, at position pos[b] + t)
// and head h, in the absorbed form of DeepSeek-V2's MLA:
//
//   s[l]          = (q_lat[b,t,h] . c[l] + q_rope[b,t,h] . kr[l]) * scale
//   o_lat[b,t,h]  = softmax_l(s) @ c        over the lines l <= pos[b] + t
//
// with line l in page block_tables[b, l / page] of the latent pool c
// (P, page, r) and the rope pool kr (P, page, dr).  This is flash attention
// with the heads as the query rows: K = [c | kr] over r + dr = 576 columns
// and V = c over r = 512, the same latent line.  bf16 queries only (pools
// in bf16, or int8 / fp8 e4m3 codes with float32 line scales).
//
// Bound on the card.  A call reads each visible line once and does
// T * H * (4r + 2dr) FLOPs a line: ~242 FLOP a line byte in bf16, near the
// tensor cores' ridge, so bytes and operations bound it about evenly and
// at the serve path's sizes (4 slots x ~680 lines, 0.8 MB) both are under
// a microsecond: launch latency and the partials' round trip through L2
// are what a call costs.
//
// Design:
// * tensor cores, 64 heads as the wgmma M.  A block owns one (slot, token)
//   row, 64 heads (H 128 is two head tiles; heads past n_heads are zero
//   rows), one chunk of the walk and one part of the output columns.  Per
//   tile of kTileLines lines: S_c = Q_lat C^T and S_r = Q_rope Kr^T by
//   wgmma m64n16k16 from shared memory (both operands K-major, float32
//   sums), then the online softmax on the accumulator fragment (a row's 16
//   scores lie in the 4 threads of a quad), then O += P C by wgmma
//   m64nNOk16 with P from registers as bf16 hi + lo (two products into the
//   same O: p keeps ~2^-17 of relative error, the reference multiplies p c
//   in float32) and B the same line tile read transposed;
// * every operand in shared memory lies in 128-byte swizzle atoms of 64
//   columns (csrc/gemm_wgmma.cuh's layout, descriptors and register-A
//   products, shared with flash attention): Q as (r / 64 + 1) atoms of 64
//   rows, a line tile as (r / 64 + 1) atoms of 16 rows, the last atom the
//   rope part; columns past r or dr (r 32, dr < 64) are zeros, so dr 8
//   is one k16 step and r 32 an N of 64 whose extra columns are dropped;
// * enough blocks: the walk is split over chunks of kChunkPages pages
//   (split-K, "flash-decoding") and r 512 over two 256-column parts (each
//   part recomputes S, cheap on the tensor cores).  The serve path's
//   decode call (B 4, H 128, 679 lines, page 16) runs 96 blocks of work;
//   a block writes its chunk's float32 (m, l, acc) to a workspace, and a
//   second kernel merges each row's chunks IN CHUNK ORDER: M = max_c m_c,
//   L = sum_c l_c e^(m_c - M), O = sum_c acc_c e^(m_c - M), out = O / L;
// * determinism: the chunk is a constant, its bounds depend only on the
//   visible line count (never on the grid, T, the SM count or the ring's
//   stage count) and the merge runs in chunk order, so the ring equals the
//   off walk, verify at T = 1 equals decode, and repeated calls give the
//   same bytes;
// * quantized pools: int8 codes (|code| <= 127) and every e4m3 value are
//   exact in bf16, so codes are staged as bf16 and the scales stay out of
//   the products: s = scale (sc_c[l] S_c + sc_r[l] S_r), and P C takes
//   p[l] sc_c[l], split hi + lo.  The reference dequantizes first
//   (float(code) * scale, then the dot), so this order differs from the
//   plain version's by float32 rounding only.  Lines past the visible ones
//   get zero codes and zero scales;
// * staging, by the block's 128 threads with 16-byte cp.async copies (an
//   8-byte one for a code rope line at dr 8, 4-byte ones for scales):
//   the queries once, then the chunk's tiles through a ring of `stages`
//   stages: stages 1 is the off walks' synchronous staging (copy, wait,
//   compute), the ring passes 2-4 (the wrapper caps it at a chunk's tiles
//   and at what fits, kernels.paged_attention.mla_core_stages).  A
//   bf16 stage is the line tile itself; a quantized stage holds the raw
//   codes and scales, widened into one bf16 tile before the products.
//   Every walk computes on the same staged values in the same order.
//
// C interface (bound with ctypes by repro_torch/kernels/paged_attention.py):
//   int mla_core_attention(q_lat, q_rope, c_pool, r_pool, c_scale, r_scale,
//                          block_tables, pos, out, work, batch, n_tokens,
//                          n_heads, latent_dim, rope_dim, page_size,
//                          n_blocks, stages, scale,
//                          kv_dtype /*0 bf16, 1 int8, 2 fp8*/, stream)
// q_lat / out are bf16 (batch, n_tokens, n_heads, latent_dim), q_rope
// (batch, n_tokens, n_heads, rope_dim); the scale pointers are null unless
// kv_dtype quantizes; `work` holds workspace_bytes(batch * n_tokens,
// n_blocks, n_heads, latent_dim) bytes; returns cudaGetLastError() after
// the two launches (cudaErrorInvalidValue for a latent / rope dim, storage
// or stage count the kernels are not built for).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "gemm_wgmma.cuh"
#include "kv_load.cuh"

namespace {

constexpr int kHeads = 64;        // heads of a block: the wgmma M
constexpr int kTileLines = 16;    // lines of a tile: S's N, P C's K
constexpr int kChunkPages = 2;    // pages of a chunk, a block's share
constexpr int kThreads = 128;     // one warpgroup
constexpr int kMaxStages = 4;
constexpr int kAtomRow = 128;     // bytes of a swizzle-atom row
constexpr float kNegInf = -1e30f;

// Sizes at latent rank R, rope dim DR and pool storage S.
template <typename S, int R, int DR>
struct Shape {
  static constexpr bool kQuant = kv_load::Quantized<S>::value;
  static constexpr int RP = (R + 63) / 64 * 64;   // latent columns, padded
  static constexpr int RA = RP / 64;              // latent atoms
  static constexpr int kAtoms = RA + 1;           // and one rope atom
  static constexpr int NO = RP < 256 ? RP : 256;  // O columns of a block
  static constexpr int kParts = RP / NO;
  static constexpr int KC = (R + 15) / 16;        // k16 steps of S_c
  static constexpr int KR = (DR + 15) / 16;       // and of S_r
  static constexpr int kQBytes = kAtoms * kHeads * kAtomRow;
  static constexpr int kTileBytes = kAtoms * kTileLines * kAtomRow;
  // a quantized stage: codes [16][R], rope codes [16][DR], scales [2][16]
  static constexpr int kRawBytes = kTileLines * (R + DR) + 2 * kTileLines * 4;
  static constexpr int kStageBytes = kQuant ? kRawBytes : kTileBytes;
  // a rope line of codes copies in 8-byte (dr 8) or 16-byte pieces
  static_assert(R % 32 == 0 && DR <= 64 && (DR <= 16 ? DR % 8 : DR % 16) == 0,
                "unsupported dims");
  static_assert(kRawBytes % 16 == 0, "stages must stay 16-byte aligned");

  // dynamic shared memory of a block: 1 KB to align the swizzle atoms,
  // Q, the widened tile of a quantized ring, the ring
  static constexpr size_t smem_bytes(int stages) {
    return 1024 + kQBytes + (kQuant ? kTileBytes : 0)
           + static_cast<size_t>(stages) * kStageBytes;
  }
};

// Lines of a chunk, and the chunks of a row with n_lines visible lines.
__host__ __device__ inline int chunk_lines(int page_size) {
  return kChunkPages * page_size;
}
__host__ __device__ inline int n_chunks(int n_lines, int page_size) {
  return (n_lines + chunk_lines(page_size) - 1) / chunk_lines(page_size);
}

// The kernels' pointers and shapes.  The workspace holds, per (row, chunk,
// head), R float32 sums and then, after all of those, (m, l): rows are
// (slot, token) pairs, b * n_tokens + t; chunks per row are the most a
// table of n_blocks pages can hold.
struct Params {
  const __nv_bfloat16* q_lat;
  const __nv_bfloat16* q_rope;
  const void* c_pool;
  const void* r_pool;
  const float* c_scale;
  const float* r_scale;
  const int32_t* block_tables;
  const int32_t* pos;
  __nv_bfloat16* out;
  float* part_acc;
  float* part_ml;
  int n_tokens, n_heads, page_size, n_blocks, max_chunks, stages;
  float scale;
};

// -- wgmma -------------------------------------------------------------------

// d (64 x 16) = (acc ? d : 0) + A (64 x 16) B^T (16 x 16): both operands
// K-major in shared memory.
__device__ __forceinline__ void mma_s(float (&d)[8], uint64_t da,
                                      uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// -- staging -----------------------------------------------------------------

// Byte offset of 16-byte chunk c (0..7) of row `row` in a swizzle atom.
__device__ __forceinline__ int swz(int row, int c) {
  return row * kAtomRow + ((c ^ (row & 7)) << 4);
}

__device__ __forceinline__ void zero16(uint8_t* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// Wait until at most stages - 1 of this thread's copy groups are in flight.
__device__ __forceinline__ void wait_stages(int stages) {
  switch (stages) {
    case 1: cp_async::wait<0>(); break;
    case 2: cp_async::wait<1>(); break;
    case 3: cp_async::wait<2>(); break;
    default: cp_async::wait<3>(); break;
  }
}

// Q of 64 heads of one row into its atoms; heads past n_heads and columns
// past R / DR are zeros.
template <int R, int DR>
__device__ __forceinline__ void stage_q(const Params& p, int row, int h0,
                                        uint8_t* q_s) {
  constexpr int RA = (R + 63) / 64;
  constexpr int kChunks = (RA + 1) * 8;       // 16-byte chunks of a row
  for (int i = threadIdx.x; i < kHeads * kChunks; i += kThreads) {
    const int r = i / kChunks, k = i % kChunks;
    const int a = k / 8, c = k % 8;
    const int h = h0 + r;
    uint8_t* dst = q_s + a * (kHeads * kAtomRow) + swz(r, c);
    const bool lat = a < RA;
    const int col = lat ? 64 * a + 8 * c : 8 * c;
    if (h < p.n_heads && col < (lat ? R : DR)) {
      const size_t q_row = static_cast<size_t>(row) * p.n_heads + h;
      cp_async::copy16(dst, lat ? p.q_lat + q_row * R + col
                                : p.q_rope + q_row * DR + col);
    } else {
      zero16(dst);
    }
  }
}

// The pool row (page * page_size + slot) of visible line t of a slot.
__device__ __forceinline__ size_t line_row(const Params& p,
                                           const int32_t* bt, int t) {
  return static_cast<size_t>(__ldg(bt + t / p.page_size)) * p.page_size
         + t % p.page_size;
}

// Lines t0 .. t0 + 15 of a slot into ring stage `st`; lines at or past
// `end` are zeros (codes and scales).  bf16 pools: the swizzled tile the
// products read.  Quantized pools: the raw codes and scales.
template <typename S, int R, int DR>
__device__ __forceinline__ void stage_lines(const Params& p,
                                            const int32_t* bt, int t0,
                                            int end, uint8_t* st) {
  using Sh = Shape<S, R, DR>;
  if constexpr (!Sh::kQuant) {
    constexpr int kChunks = Sh::kAtoms * 8;
    const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.c_pool);
    const __nv_bfloat16* rg = static_cast<const __nv_bfloat16*>(p.r_pool);
    for (int i = threadIdx.x; i < kTileLines * kChunks; i += kThreads) {
      const int line = i / kChunks, k = i % kChunks;
      const int a = k / 8, c = k % 8;
      uint8_t* dst = st + a * (kTileLines * kAtomRow) + swz(line, c);
      const bool lat = a < Sh::RA;
      const int col = lat ? 64 * a + 8 * c : 8 * c;
      const int t = t0 + line;
      if (t < end && col < (lat ? R : DR)) {
        const size_t row = line_row(p, bt, t);
        cp_async::copy16(dst, lat ? cg + row * R + col : rg + row * DR + col);
      } else {
        zero16(dst);
      }
    }
  } else {
    constexpr int RC = DR < 16 ? DR : 16;     // bytes per rope-code copy
    constexpr int GC = R / 16, GR = DR / RC;  // copies per line
    const uint8_t* cg = static_cast<const uint8_t*>(p.c_pool);
    const uint8_t* rg = static_cast<const uint8_t*>(p.r_pool);
    for (int i = threadIdx.x; i < kTileLines * (GC + GR); i += kThreads) {
      const int line = i / (GC + GR), v = i % (GC + GR);
      const bool lat = v < GC;
      uint8_t* dst = lat ? st + line * R + 16 * v
                         : st + kTileLines * R + line * DR + (v - GC) * RC;
      const int t = t0 + line;
      if (t < end) {
        const size_t row = line_row(p, bt, t);
        if (lat) {
          cp_async::copy16(dst, cg + row * R + 16 * v);
        } else if constexpr (RC == 16) {
          cp_async::copy16(dst, rg + row * DR + (v - GC) * RC);
        } else {
          cp_async::copy8(dst, rg + row * DR + (v - GC) * RC);
        }
      } else if (lat || RC == 16) {
        zero16(dst);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      }
    }
    float* sc = reinterpret_cast<float*>(st + kTileLines * (R + DR));
    for (int i = threadIdx.x; i < 2 * kTileLines; i += kThreads) {
      const int is_r = i >= kTileLines;
      const int t = t0 + i - is_r * kTileLines;
      if (t < end) {
        cp_async::copy4(sc + i, (is_r ? p.r_scale : p.c_scale)
                                    + line_row(p, bt, t));
      } else {
        sc[i] = 0.0f;
      }
    }
  }
}

// A quantized stage's codes widened into the swizzled bf16 tile (exact:
// every int8 and e4m3 code is a bf16 value); padding columns zeros.
template <typename S, int R, int DR>
__device__ __forceinline__ void widen_tile(const uint8_t* raw,
                                           uint8_t* tile) {
  using Sh = Shape<S, R, DR>;
  constexpr int kChunks = Sh::kAtoms * 8;
  for (int i = threadIdx.x; i < kTileLines * kChunks; i += kThreads) {
    const int line = i / kChunks, k = i % kChunks;
    const int a = k / 8, c = k % 8;
    uint8_t* dst = tile + a * (kTileLines * kAtomRow) + swz(line, c);
    const bool lat = a < Sh::RA;
    const int col = lat ? 64 * a + 8 * c : 8 * c;
    if (col < (lat ? R : DR)) {
      const S* src = reinterpret_cast<const S*>(
          lat ? raw + line * R + col : raw + kTileLines * R + line * DR + col);
      float f[8];
      kv_load::widen<8, true>(src, f);
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(wg::bf16x2(f[0], f[1]), wg::bf16x2(f[2], f[3]),
                     wg::bf16x2(f[4], f[5]), wg::bf16x2(f[6], f[7]));
    } else {
      zero16(dst);
    }
  }
}

// -- the kernels -------------------------------------------------------------

// One block: row blockIdx.z (slot b = row / n_tokens, token row %
// n_tokens), heads 64 blockIdx.y .., chunk blockIdx.x / kParts, output
// columns NO (blockIdx.x % kParts) ..; writes the chunk's (m, l, acc).
template <typename S, int R, int DR>
__global__ void __launch_bounds__(kThreads)
    mla_split_bf16_kernel(const __grid_constant__ Params p) {
  using Sh = Shape<S, R, DR>;
  constexpr int NO = Sh::NO;
  constexpr int kAcc = NO / 2;                // O sums per thread

  const int part = blockIdx.x % Sh::kParts;
  const int chunk = blockIdx.x / Sh::kParts;
  const int h0 = blockIdx.y * kHeads;
  const int row = blockIdx.z;
  const int b = row / p.n_tokens, tok = row % p.n_tokens;
  const int n_lines = min(p.pos[b] + tok + 1, p.n_blocks * p.page_size);
  const int c0 = chunk * chunk_lines(p.page_size);
  if (c0 >= n_lines) return;                  // past this row's walk
  const int c1 = min(c0 + chunk_lines(p.page_size), n_lines);
  const int n_tiles = (c1 - c0 + kTileLines - 1) / kTileLines;
  const int32_t* bt = p.block_tables + static_cast<size_t>(b) * p.n_blocks;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* wide = q_s + Sh::kQBytes;          // the widened quantized tile
  uint8_t* ring = wide + (Sh::kQuant ? Sh::kTileBytes : 0);
  const int stages = p.stages;

  stage_q<R, DR>(p, row, h0, q_s);
  cp_async::commit();
  for (int j = 0; j < stages - 1; ++j) {
    if (j < n_tiles)
      stage_lines<S, R, DR>(p, bt, c0 + j * kTileLines, c1,
                            ring + j * Sh::kStageBytes);
    cp_async::commit();
  }

  const int tt = threadIdx.x, lane = tt % 32, quad = lane % 4;
  const uint32_t q_addr = wg::smem_u32(q_s);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();          // every thread is done with tile j - 1
    const int jn = j + stages - 1;
    if (jn < n_tiles)
      stage_lines<S, R, DR>(p, bt, c0 + jn * kTileLines, c1,
                            ring + (jn % stages) * Sh::kStageBytes);
    cp_async::commit();
    wait_stages(stages);      // Q and tile j have landed (this thread's)
    wg::fence_proxy_async();
    __syncthreads();
    const uint8_t* st = ring + (j % stages) * Sh::kStageBytes;
    const uint8_t* tile = st;
    if constexpr (Sh::kQuant) {
      widen_tile<S, R, DR>(st, wide);
      wg::fence_proxy_async();
      __syncthreads();
      tile = wide;
    }
    const uint32_t t_addr = wg::smem_u32(tile);

    // S_c = Q_lat C^T, S_r = Q_rope Kr^T (float32 sums of bf16 products)
    float sc[8], sr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = sr[i] = 0.0f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::KC; ++kk) {
      const uint32_t qo = (kk / 4) * (kHeads * kAtomRow) + (kk % 4) * 32;
      const uint32_t to = (kk / 4) * (kTileLines * kAtomRow) + (kk % 4) * 32;
      mma_s(sc, wg::sw128_desc(q_addr + qo, 0, 1024),
            wg::sw128_desc(t_addr + to, 0, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < Sh::KR; ++kk) {
      const uint32_t qo = Sh::RA * (kHeads * kAtomRow) + kk * 32;
      const uint32_t to = Sh::RA * (kTileLines * kAtomRow) + kk * 32;
      mma_s(sr, wg::sw128_desc(q_addr + qo, 0, 1024),
            wg::sw128_desc(t_addr + to, 0, 1024), kk > 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::pin(sc);
    wg::pin(sr);

    // scores of this thread's rows (hh: +8) and lines 8 jj + 2 quad + e;
    // masked past the chunk's visible lines; running max over the quad
    const int t0 = c0 + j * kTileLines;
    const float* scales = reinterpret_cast<const float*>(
        st + kTileLines * (R + DR));         // read only when quantized
    float s[8], c_sc[4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int line = 8 * jj + 2 * quad + e;
        c_sc[2 * jj + e] = Sh::kQuant ? scales[line] : 1.0f;
        const float r_sc = Sh::kQuant ? scales[kTileLines + line] : 1.0f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * jj + 2 * hh + e;
          float x = Sh::kQuant ? c_sc[2 * jj + e] * sc[i] + r_sc * sr[i]
                               : sc[i] + sr[i];
          x = t0 + line < c1 ? x * p.scale : kNegInf;
          s[i] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = expf(m[hh] - mx[hh]);
      m[hh] = mx[hh];
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int hh = (i / 2) % 2;
      s[i] = expf(s[i] - m[hh]);
      l[hh] += s[i];
    }
#pragma unroll
    for (int jj = 0; jj < NO / 8; ++jj) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        acc[4 * jj + 2 * hh] *= alpha[hh];
        acc[4 * jj + 2 * hh + 1] *= alpha[hh];
      }
    }

    // P (times each line's latent scale) as A fragments, bf16 hi + lo:
    // register r holds the pair (s[2 r], s[2 r + 1])
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a0 = s[2 * r] * c_sc[2 * (r / 2)];
      const float a1 = s[2 * r + 1] * c_sc[2 * (r / 2) + 1];
      p_hi[r] = wg::bf16x2(a0, a1);
      const float h0f = __uint_as_float(p_hi[r] << 16);
      const float h1f = __uint_as_float(p_hi[r] & 0xffff0000u);
      p_lo[r] = wg::bf16x2(a0 - h0f, a1 - h1f);   // both differences exact
    }

    // O += P C over this block's columns
    const uint64_t dc = wg::sw128_desc(
        t_addr + part * (NO / 64) * (kTileLines * kAtomRow),
        kTileLines * kAtomRow, 1024);
    wg::wgmma_fence();
    wg::MmaRegA<NO>::run(acc, p_hi, dc);
    wg::MmaRegA<NO>::run(acc, p_lo, dc);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::pin(acc);
    wg::pin_u32(p_hi);
    wg::pin_u32(p_lo);
  }
  cp_async::wait<0>();

  // the chunk's (m, l, acc) of this thread's rows
  const size_t base = (static_cast<size_t>(row) * p.max_chunks + chunk)
                      * p.n_heads;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int h = h0 + 16 * (tt / 32) + lane / 4 + 8 * hh;
    if (h >= p.n_heads) continue;
    if (part == 0 && quad == 0)
      *reinterpret_cast<float2*>(p.part_ml + (base + h) * 2) =
          make_float2(m[hh], l[hh]);
    float* dst = p.part_acc + (base + h) * R + part * NO + 2 * quad;
#pragma unroll
    for (int jj = 0; jj < NO / 8; ++jj) {
      if (part * NO + 8 * jj + 2 * quad < R)
        *reinterpret_cast<float2*>(dst + 8 * jj) =
            make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
    }
  }
}

// One block per (head blockIdx.x, row blockIdx.y): the row's chunks merged
// in chunk order, out = O / max(L, 1e-30) rounded once to bf16.
template <int R>
__global__ void __launch_bounds__(kThreads)
    mla_combine_kernel(const __grid_constant__ Params p) {
  const int h = blockIdx.x, row = blockIdx.y;
  const int b = row / p.n_tokens, tok = row % p.n_tokens;
  const int n_lines = min(p.pos[b] + tok + 1, p.n_blocks * p.page_size);
  const int nc = n_chunks(n_lines, p.page_size);
  const size_t base = static_cast<size_t>(row) * p.max_chunks * p.n_heads;
  const size_t step = p.n_heads;              // from one chunk to the next
  float mx = kNegInf;
  for (int c = 0; c < nc; ++c)
    mx = fmaxf(mx, p.part_ml[(base + c * step + h) * 2]);
  float den = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const float2 ml = *reinterpret_cast<const float2*>(
        p.part_ml + (base + c * step + h) * 2);
    den += ml.y * expf(ml.x - mx);
  }
  const float inv = 1.0f / fmaxf(den, 1e-30f);
  for (int col = 4 * threadIdx.x; col < R; col += 4 * kThreads) {
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < nc; ++c) {
      const float w = expf(p.part_ml[(base + c * step + h) * 2] - mx);
      const float4 a = *reinterpret_cast<const float4*>(
          p.part_acc + (base + c * step + h) * R + col);
      o.x += a.x * w;
      o.y += a.y * w;
      o.z += a.z * w;
      o.w += a.w * w;
    }
    __nv_bfloat16* dst =
        p.out + (static_cast<size_t>(row) * p.n_heads + h) * R + col;
    *reinterpret_cast<uint2*>(dst) = make_uint2(
        wg::bf16x2(o.x * inv, o.y * inv), wg::bf16x2(o.z * inv, o.w * inv));
  }
}

// -- host side ---------------------------------------------------------------

// Bytes of the workspace of a call over `rows` (slot, token) rows, a table
// of n_blocks pages, n_heads heads at latent rank r
// (kernels/paged_attention.py::mla_workspace_bytes is the same count).
inline size_t workspace_bytes(int rows, int n_blocks, int n_heads, int r) {
  const size_t chunks = (n_blocks + kChunkPages - 1) / kChunkPages;
  return static_cast<size_t>(rows) * chunks * n_heads * (r + 2) * 4;
}

// Launch the split and the combine kernels for a call; `stages` 1 stages
// each tile synchronously (the off walks), 2-4 keep that many tiles in
// flight (the ring).  `work` holds workspace_bytes(batch * n_tokens, ...)
// bytes.
template <typename S, int R, int DR>
int launch(Params p, int batch, void* work, cudaStream_t stream) {
  using Sh = Shape<S, R, DR>;
  const size_t bytes = Sh::smem_bytes(p.stages);
  if (p.stages < 1 || p.stages > kMaxStages || bytes > 227 * 1024 ||
      batch * p.n_tokens > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.max_chunks = (p.n_blocks + kChunkPages - 1) / kChunkPages;
  const int rows = batch * p.n_tokens;
  p.part_acc = static_cast<float*>(work);
  p.part_ml = p.part_acc + static_cast<size_t>(rows) * p.max_chunks
                               * p.n_heads * R;
  auto split = mla_split_bf16_kernel<S, R, DR>;
  static size_t opted_in = 48 * 1024;
  if (bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = bytes;
  }
  const dim3 grid(p.max_chunks * Sh::kParts,
                  (p.n_heads + kHeads - 1) / kHeads, rows);
  split<<<grid, kThreads, bytes, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mla_combine_kernel<R><<<dim3(p.n_heads, rows), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the call's pointer and shape arguments, carried through the dispatch
struct Args {
  Params p;
  int batch;
  void* work;
  cudaStream_t stream;
};

template <typename S, int R>
int dispatch_rope(int rope_dim, const Args& a) {
#define MLA_DR(DR)                                                          \
  case DR:                                                                  \
    return launch<S, R, DR>(a.p, a.batch, a.work, a.stream);
  switch (rope_dim) {
    MLA_DR(8)
    MLA_DR(16)
    MLA_DR(32)
    MLA_DR(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MLA_DR
}

template <typename S>
int dispatch_latent(int latent_dim, int rope_dim, const Args& a) {
#define MLA_R(R)                                                            \
  case R:                                                                   \
    return dispatch_rope<S, R>(rope_dim, a);
  switch (latent_dim) {
    MLA_R(32)
    MLA_R(64)
    MLA_R(128)
    MLA_R(256)
    MLA_R(512)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MLA_R
}

}  // namespace

extern "C" int mla_core_attention(
    const void* q_lat, const void* q_rope, const void* c_pool,
    const void* r_pool, const void* c_scale, const void* r_scale,
    const void* block_tables, const void* pos, void* out, void* work,
    int batch, int n_tokens, int n_heads, int latent_dim, int rope_dim,
    int page_size, int n_blocks, int stages, float scale, int kv_dtype,
    void* stream) {
  if (batch <= 0 || n_tokens <= 0 || n_heads <= 0 || page_size <= 0
      || n_blocks <= 0 || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kv_load::kSame && (c_scale == nullptr || r_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(q_lat),
                 static_cast<const __nv_bfloat16*>(q_rope), c_pool, r_pool,
                 static_cast<const float*>(c_scale),
                 static_cast<const float*>(r_scale),
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(pos),
                 static_cast<__nv_bfloat16*>(out), nullptr, nullptr,
                 n_tokens, n_heads, page_size, n_blocks, /*max_chunks=*/0,
                 stages, scale};
  const Args a{p, batch, work, static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case kv_load::kSame:
      return dispatch_latent<__nv_bfloat16>(latent_dim, rope_dim, a);
    case kv_load::kInt8:
      return dispatch_latent<int8_t>(latent_dim, rope_dim, a);
    case kv_load::kFp8:
      return dispatch_latent<__nv_fp8_e4m3>(latent_dim, rope_dim, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
