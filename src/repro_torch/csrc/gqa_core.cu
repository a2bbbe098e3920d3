// The GQA paged-attention core on Hopper's tensor cores (sm_90a): the bf16
// path of the three walks that replace the Pallas TPU kernels of
// src/repro/kernels/paged_attention.py, one entry point built once:
// * decode (`paged_attention`, :345; `_paged_decode_kernel`, :252):
//   n_tokens 1, stages 1;
// * multi-token verification (`paged_attention_verify`, :557;
//   `_paged_verify_kernel`, :457): stages 1;
// * the `pipeline="double"` walk of both (`_gqa_paged_double`, :803;
//   `_gqa_double_kernel`, :673): up to 4 stages, at most a chunk's tiles
//   (1 at page 16, where a chunk is one tile).
// Their float32 paths stay on the CUDA cores (csrc/paged_attention.cu,
// csrc/paged_attention_verify.cu, csrc/paged_attention_ring.cu); the
// wrappers in repro_torch/kernels/paged_attention.py pick the source by the
// queries' dtype.
// For slot b, KV head h and query token t (T = 1 for decode, at position
// pos[b] + t), the G query heads of h are the rows r = t G + g of a
// (T G, hd) slab; row r sees the lines k_pos <= pos[b] + t of the slot's
// pages (P, page, KV, hd), reached through its block-table row:
//
//   s[l]  = (q[r] . k[l]) * scale,  then the optional tanh soft cap
//   out[r] = softmax_l(s) @ v       (online, float32; / max(l, 1e-30))
//   lse[r] = log sum_l exp(s[l])    (optional, float32: m + log(l))
//
// A row that sees no line (pos[b] + t < 0: a rank of a sequence-sharded
// cache whose lines all lie past the position) gets out = 0 and lse = -inf;
// nothing of the slot's table is read then.
//
// bf16 queries only (pools in bf16, or int8 / fp8 e4m3 codes with float32
// scales (P, page, KV)).
//
// Bound on the card: bytes.  A call reads each visible K / V line of a KV
// head once (2 hd elements, plus two scales when quantized) and does
// 4 hd FLOPs per (row, line it sees): ~5 FLOP a byte at qwen3-14b's
// verify (T 5, G 5, hd 128), far under the ridge.  At the serve path's
// sizes (4 slots x ~200 lines x 8 KV heads, ~3 MB) the bound is about a
// microsecond, so what a call costs is latency: the CUDA-core kernels it
// replaces walked each slot's lines one at a time on 32-128 blocks, with
// 8 rows' dot products in shuffles a line (PERF.md: 38x and 56x the
// bound).
//
// Design:
// * tensor cores, the rows as the wgmma M.  A block is one warpgroup and
//   owns one (slot, KV head), one tile of up to kRows of its T G rows
//   (rows past T G are zero rows; T G > 64 takes several row tiles) and
//   one chunk of the walk.  Per tile of kTileLines lines: S = Q K^T by
//   wgmma m64n16k16 from shared memory (both operands K-major, float32
//   sums), scale, soft cap and each row's causal mask on the accumulator
//   fragment (a row's 16 scores lie in the 4 threads of a quad), the
//   online softmax, then O += P V by wgmma m64nNOk16 with P from registers
//   as bf16 hi + lo (two products into the same O: p keeps ~2^-17 of
//   relative error, the reference multiplies p v in float32) and V read
//   transposed through its descriptor;
// * every operand in shared memory lies in 128-byte swizzle atoms of 64
//   columns (csrc/gemm_wgmma.cuh's layout, descriptors and register-A
//   products): Q as HP / 64 atoms of 64 rows, a K or V tile as HP / 64
//   atoms of 16 lines; columns past hd (hd 16, 32) are zeros, so O's N is
//   64 there and its extra columns are dropped;
// * enough blocks: the walk is split over chunks of kChunkPages pages
//   (split-K, "flash-decoding").  A chunk's bounds depend only on the
//   slot's visible line count, min(pos + T, table lines): never on the
//   grid, T G, the SM count or the ring's stage count.  Rows whose limit
//   ends before a chunk see none of its lines: their p is 0 by the mask,
//   not by an underflow, so their (m, l, acc) stay (-1e30, 0, 0);
// * one launch a call: a block of a row group (slot, KV head, row tile)
//   with more than one chunk writes its chunk's float32 (m, l, acc) to a
//   workspace, fences, and counts itself on the row group's counter; the
//   block that arrives last reads every chunk back from L2 (`__ldcg`) and
//   merges them IN CHUNK ORDER, M = max_c m_c, L = sum_c l_c e^(m_c - M),
//   O = sum_c acc_c e^(m_c - M), out = O / max(L, 1e-30), then sets the
//   counter back to 0 (the wrapper zeroes the counters once, when it
//   allocates them).  A row group of one chunk writes O / max(l, 1e-30)
//   directly: the same bits, since then L = l and O = acc;
// * the log-sum-exp (`lse` not null, flash-decoding across ranks that hold
//   a sequence's lines in blocks): M + log(L) where the output is written,
//   -inf for a row with L = 0; `out` is the same bits with or without it;
// * determinism: the chunk is a constant, the merge runs in chunk order
//   whichever block arrives last, so the ring equals the off walk, verify
//   at T = 1 equals decode, and repeated calls give the same bytes;
// * quantized pools: int8 codes (|code| <= 127) and every e4m3 value are
//   exact in bf16, so codes are staged as bf16 and the scales stay out of
//   the products: s = scale (ks[l] (q . code_k[l])), and P V takes
//   p[l] vs[l], split hi + lo.  The reference dequantizes first
//   (float(code) * scale, then the dot), so this order differs from the
//   plain version's by float32 rounding only.  Lines past the chunk get
//   zero codes and zero scales;
// * staging, by the block's 128 threads with 16-byte cp.async copies
//   (4-byte ones for the scales, a column of the (page, KV) scale block):
//   the queries once, then the chunk's tiles through a ring of `stages`
//   stages: stages 1 is the off walks' synchronous staging (copy, wait,
//   compute), the ring passes up to 4 (the wrapper caps it at a chunk's
//   tiles and at what fits, kernels.paged_attention.gqa_core_stages).  A bf16
//   stage is the K and V tiles themselves; a quantized stage holds the raw
//   codes and scales, widened into two bf16 tiles before the products.
//   Every walk computes on the same staged values in the same order.
//
// C interface (bound with ctypes by repro_torch/kernels/paged_attention.py):
//   int gqa_core_attention(q, k_pool, v_pool, k_scale, v_scale,
//                          block_tables, pos, out, lse, work, counters, batch,
//                          n_tokens, kv_heads, groups, head_dim, page_size,
//                          n_blocks, stages, scale, soft_cap,
//                          kv_dtype /*0 bf16, 1 int8, 2 fp8*/, stream)
// q / out are bf16 (batch, n_tokens, kv_heads, groups, head_dim); the scale
// pointers are null unless kv_dtype quantizes; `lse` is null or float32
// (batch, n_tokens, kv_heads, groups); `work` holds
// batch kv_heads n_tokens groups ceil(n_blocks / kChunkPages) (head_dim +
// 2) float32s; `counters` holds batch kv_heads ceil(n_tokens groups / 64)
// int32 zeros, and holds zeros again when the launch has run.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim, storage or stage count the kernel is not built for).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "gemm_wgmma.cuh"
#include "kv_load.cuh"

namespace {

constexpr int kRows = 64;          // rows of a block: the wgmma M
constexpr int kTileLines = 16;     // lines of a tile: S's N, P V's K
// pages of a chunk, a block's share of a walk (the wrappers'
// GQA_CHUNK_PAGES; PERF.md's chunk study says why 1)
constexpr int kChunkPages = 1;
constexpr int kThreads = 128;      // one warpgroup
constexpr int kMaxStages = 4;
constexpr int kAtomRow = 128;      // bytes of a swizzle-atom row
constexpr int kMergeBatch = 8;     // chunks a merging thread loads at once
constexpr float kNegInf = -1e30f;

// Sizes at head dim HD and pool storage S.
template <typename S, int HD>
struct Shape {
  static constexpr bool kQuant = kv_load::Quantized<S>::value;
  static constexpr int HP = HD < 64 ? 64 : HD;    // columns, padded: O's N
  static constexpr int QA = HP / 64;              // atoms of a row
  static constexpr int KS = HD / 16;              // k16 steps of S
  static constexpr int kQBytes = QA * kRows * kAtomRow;
  static constexpr int kTileBytes = QA * kTileLines * kAtomRow;  // K or V
  // a quantized stage: K codes [16][HD], V codes [16][HD], scales [2][16]
  static constexpr int kRawBytes = 2 * kTileLines * HD + 2 * kTileLines * 4;
  static constexpr int kStageBytes = kQuant ? kRawBytes : 2 * kTileBytes;
  static_assert(HD % 16 == 0 && HD <= 256 && (HD >= 64 || 64 % HD == 0),
                "unsupported head dim");
  static_assert(kRawBytes % 16 == 0, "stages must stay 16-byte aligned");

  // dynamic shared memory of a block: 1 KB to align the swizzle atoms,
  // Q, the widened K and V tiles of a quantized ring, the ring
  static constexpr size_t smem_bytes(int stages) {
    return 1024 + kQBytes + (kQuant ? 2 * kTileBytes : 0)
           + static_cast<size_t>(stages) * kStageBytes;
  }
};

// Lines of a chunk, and the chunks of a walk over n_lines visible lines.
__host__ __device__ inline int chunk_lines(int page_size) {
  return kChunkPages * page_size;
}
__host__ __device__ inline int n_chunks(int n_lines, int page_size) {
  return (n_lines + chunk_lines(page_size) - 1) / chunk_lines(page_size);
}

// The kernel's pointers and shapes.  The workspace holds, per (slot, KV
// head, row, chunk), HD float32 sums and then, after all of those, (m, l);
// rows are r = t G + g of a (slot, KV head); chunks per row are the most a
// table of n_blocks pages can hold.  One counter per row group (slot, KV
// head, row tile).
struct Params {
  const __nv_bfloat16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int32_t* block_tables;
  const int32_t* pos;
  __nv_bfloat16* out;
  float* lse;                 // null: no log-sum-exp asked
  float* part_acc;
  float* part_ml;
  int* counters;
  int n_tokens, kv_heads, groups, page_size, n_blocks, max_chunks, row_tiles,
      stages;
  float scale, soft_cap;
};

// -- wgmma and staging helpers -----------------------------------------------

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

// Offset of row r = t G + g of (slot b, KV head h) in q / out.
__device__ __forceinline__ size_t row_offset(const Params& p, int b, int h,
                                             int r, int hd) {
  const int t = r / p.groups, g = r % p.groups;
  return ((static_cast<size_t>(b) * p.n_tokens + t) * p.kv_heads + h)
             * p.groups * hd
         + static_cast<size_t>(g) * hd;
}

// Offset of row r's log-sum-exp in lse (batch, n_tokens, kv_heads, groups).
__device__ __forceinline__ size_t lse_offset(const Params& p, int b, int h,
                                             int r) {
  const int t = r / p.groups, g = r % p.groups;
  return ((static_cast<size_t>(b) * p.n_tokens + t) * p.kv_heads + h)
             * p.groups
         + g;
}

// The log-sum-exp of a row whose scores have max m and sum l of e^(s - m).
__device__ __forceinline__ float log_sum_exp(float m, float l) {
  return l > 0.0f ? m + logf(l) : -INFINITY;
}

// Q of the 64 rows row0 .. of (slot b, KV head h) into its atoms; rows
// past T G and columns past HD are zeros.
template <int HD>
__device__ __forceinline__ void stage_q(const Params& p, int b, int h,
                                        int row0, uint8_t* q_s) {
  constexpr int QA = Shape<__nv_bfloat16, HD>::QA;
  constexpr int kChunks = QA * 8;             // 16-byte chunks of a row
  const int n_rows = p.n_tokens * p.groups;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, k = i % kChunks;
    const int a = k / 8, c = k % 8;
    const int col = 64 * a + 8 * c;
    uint8_t* dst = q_s + a * (kRows * kAtomRow) + swz(r, c);
    if (row0 + r < n_rows && col < HD) {
      cp_async::copy16(dst, p.q + row_offset(p, b, h, row0 + r, HD) + col);
    } else {
      zero16(dst);
    }
  }
}

// The pool line (page * page_size + slot) of visible line t of a slot.
__device__ __forceinline__ size_t line_row(const Params& p,
                                           const int32_t* bt, int t) {
  return static_cast<size_t>(__ldg(bt + t / p.page_size)) * p.page_size
         + t % p.page_size;
}

// Lines t0 .. t0 + 15 of KV head h of a slot into ring stage `st`; lines at
// or past `end` are zeros (codes and scales).  bf16 pools: the swizzled K
// and V tiles the products read.  Quantized pools: the raw codes and
// scales.
template <typename S, int HD>
__device__ __forceinline__ void stage_lines(const Params& p,
                                            const int32_t* bt, int h, int t0,
                                            int end, uint8_t* st) {
  using Sh = Shape<S, HD>;
  const size_t line_stride = static_cast<size_t>(p.kv_heads) * HD;
  if constexpr (!Sh::kQuant) {
    constexpr int kChunks = Sh::QA * 8;
    constexpr int kPerTile = kTileLines * kChunks;
    for (int i = threadIdx.x; i < 2 * kPerTile; i += kThreads) {
      const int is_v = i >= kPerTile, j = i - is_v * kPerTile;
      const int line = j / kChunks, k = j % kChunks;
      const int a = k / 8, c = k % 8;
      const int col = 64 * a + 8 * c;
      uint8_t* dst = st + is_v * Sh::kTileBytes
                     + a * (kTileLines * kAtomRow) + swz(line, c);
      const int t = t0 + line;
      if (t < end && col < HD) {
        const __nv_bfloat16* pool = static_cast<const __nv_bfloat16*>(
            is_v ? p.v_pool : p.k_pool);
        cp_async::copy16(dst, pool + line_row(p, bt, t) * line_stride
                                  + static_cast<size_t>(h) * HD + col);
      } else {
        zero16(dst);
      }
    }
  } else {
    constexpr int GC = HD / 16;               // 16-byte copies of a line
    constexpr int kPerTile = kTileLines * GC;
    for (int i = threadIdx.x; i < 2 * kPerTile; i += kThreads) {
      const int is_v = i >= kPerTile, j = i - is_v * kPerTile;
      const int line = j / GC, v = j % GC;
      uint8_t* dst = st + is_v * kTileLines * HD + line * HD + 16 * v;
      const int t = t0 + line;
      if (t < end) {
        const uint8_t* pool = static_cast<const uint8_t*>(
            is_v ? p.v_pool : p.k_pool);
        cp_async::copy16(dst, pool + line_row(p, bt, t) * line_stride
                                  + static_cast<size_t>(h) * HD + 16 * v);
      } else {
        zero16(dst);
      }
    }
    float* sc = reinterpret_cast<float*>(st + 2 * kTileLines * HD);
    for (int i = threadIdx.x; i < 2 * kTileLines; i += kThreads) {
      const int is_v = i >= kTileLines;
      const int t = t0 + i - is_v * kTileLines;
      if (t < end) {
        cp_async::copy4(sc + i, (is_v ? p.v_scale : p.k_scale)
                                    + line_row(p, bt, t) * p.kv_heads + h);
      } else {
        sc[i] = 0.0f;
      }
    }
  }
}

// A quantized stage's K and V codes widened into the swizzled bf16 tiles
// (exact: every int8 and e4m3 code is a bf16 value); padding columns zeros.
template <typename S, int HD>
__device__ __forceinline__ void widen_tiles(const uint8_t* raw,
                                            uint8_t* tiles) {
  using Sh = Shape<S, HD>;
  constexpr int kChunks = Sh::QA * 8;
  constexpr int kPerTile = kTileLines * kChunks;
  for (int i = threadIdx.x; i < 2 * kPerTile; i += kThreads) {
    const int is_v = i >= kPerTile, j = i - is_v * kPerTile;
    const int line = j / kChunks, k = j % kChunks;
    const int a = k / 8, c = k % 8;
    const int col = 64 * a + 8 * c;
    uint8_t* dst = tiles + is_v * Sh::kTileBytes
                   + a * (kTileLines * kAtomRow) + swz(line, c);
    if (col < HD) {
      const S* src = reinterpret_cast<const S*>(
          raw + is_v * kTileLines * HD + line * HD + col);
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

// -- the kernel --------------------------------------------------------------

// One block: slot blockIdx.z, KV head blockIdx.y % kv_heads, row tile
// blockIdx.y / kv_heads, chunk blockIdx.x.  Writes the output rows of its
// row group when the group has one chunk; otherwise its chunk's (m, l,
// acc), and the group's last block merges them.
template <typename S, int HD>
__global__ void __launch_bounds__(kThreads)
    gqa_split_bf16_kernel(const __grid_constant__ Params p) {
  using Sh = Shape<S, HD>;
  constexpr int NO = Sh::HP;                  // O's N
  constexpr int kAcc = NO / 2;                // O sums per thread

  const int chunk = blockIdx.x;
  const int h = blockIdx.y % p.kv_heads, tile = blockIdx.y / p.kv_heads;
  const int b = blockIdx.z;
  const int row0 = tile * kRows;
  const int n_rows = p.n_tokens * p.groups;
  const int pos0 = p.pos[b];
  const int n_lines = min(pos0 + p.n_tokens, p.n_blocks * p.page_size);
  const int c0 = chunk * chunk_lines(p.page_size);
  if (c0 >= n_lines) {                        // past this slot's walk
    if (chunk == 0) {
      // no line visible at all: the tile's rows are 0, their lse -inf
      const int rows_here = min(kRows, n_rows - row0);
      for (int i = threadIdx.x; i < rows_here * HD; i += kThreads) {
        const int r = row0 + i / HD;
        p.out[row_offset(p, b, h, r, HD) + i % HD] = __float2bfloat16(0.0f);
        if (p.lse != nullptr && i % HD == 0)
          p.lse[lse_offset(p, b, h, r)] = -INFINITY;
      }
    }
    return;
  }
  const int c1 = min(c0 + chunk_lines(p.page_size), n_lines);
  const int nc = n_chunks(n_lines, p.page_size);
  const int n_tiles = (c1 - c0 + kTileLines - 1) / kTileLines;
  const int32_t* bt = p.block_tables + static_cast<size_t>(b) * p.n_blocks;

  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  __shared__ float s_max[kRows];      // each merged row's M
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* wide = q_s + Sh::kQBytes;          // the widened quantized tiles
  uint8_t* ring = wide + (Sh::kQuant ? 2 * Sh::kTileBytes : 0);
  const int stages = p.stages;

  stage_q<HD>(p, b, h, row0, q_s);
  cp_async::commit();
  for (int j = 0; j < stages - 1; ++j) {
    if (j < n_tiles)
      stage_lines<S, HD>(p, bt, h, c0 + j * kTileLines, c1,
                         ring + j * Sh::kStageBytes);
    cp_async::commit();
  }

  // this thread's rows (hh: +8) of the accumulator fragments and the last
  // line each sees (-1: a zero row past T G)
  const int tt = threadIdx.x, lane = tt % 32, quad = lane % 4;
  int row[2], lim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = row0 + 16 * (tt / 32) + lane / 4 + 8 * hh;
    lim[hh] = row[hh] < n_rows ? pos0 + row[hh] / p.groups : -1;
  }
  const uint32_t q_addr = wg::smem_u32(q_s);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();          // every thread is done with tile j - 1
    const int jn = j + stages - 1;
    if (jn < n_tiles)
      stage_lines<S, HD>(p, bt, h, c0 + jn * kTileLines, c1,
                         ring + (jn % stages) * Sh::kStageBytes);
    cp_async::commit();
    wait_stages(stages);      // Q and tile j have landed (this thread's)
    wg::fence_proxy_async();
    __syncthreads();
    const uint8_t* st = ring + (j % stages) * Sh::kStageBytes;
    const uint8_t* tiles = st;
    if constexpr (Sh::kQuant) {
      widen_tiles<S, HD>(st, wide);
      wg::fence_proxy_async();
      __syncthreads();
      tiles = wide;
    }
    const uint32_t k_addr = wg::smem_u32(tiles);
    const uint32_t v_addr = k_addr + Sh::kTileBytes;

    // S = Q K^T (float32 sums of bf16 products)
    float sacc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sacc[i] = 0.0f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::KS; ++kk) {
      const uint32_t qo = (kk / 4) * (kRows * kAtomRow) + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * (kTileLines * kAtomRow) + (kk % 4) * 32;
      mma_s(sacc, wg::sw128_desc(q_addr + qo, 0, 1024),
            wg::sw128_desc(k_addr + ko, 0, 1024), kk > 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::pin(sacc);

    // scores of this thread's rows and lines 8 jj + 2 quad + e: scaled,
    // capped, masked past the chunk and past each row's limit; running
    // max over the quad
    const int t0 = c0 + j * kTileLines;
    const float* scales = reinterpret_cast<const float*>(
        st + 2 * kTileLines * HD);           // read only when quantized
    float s[8], v_sc[4];
    bool ok[8];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int line = 8 * jj + 2 * quad + e;
        const float k_sc = Sh::kQuant ? scales[line] : 1.0f;
        v_sc[2 * jj + e] = Sh::kQuant ? scales[kTileLines + line] : 1.0f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * jj + 2 * hh + e;
          float x = (Sh::kQuant ? k_sc * sacc[i] : sacc[i]) * p.scale;
          if (p.soft_cap > 0.0f) x = tanhf(x / p.soft_cap) * p.soft_cap;
          ok[i] = t0 + line < c1 && t0 + line <= lim[hh];
          s[i] = ok[i] ? x : kNegInf;
          mx[hh] = fmaxf(mx[hh], s[i]);
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
      s[i] = ok[i] ? expf(s[i] - m[hh]) : 0.0f;
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

    // P (times each line's V scale) as A fragments, bf16 hi + lo:
    // register r holds the pair (s[2 r], s[2 r + 1])
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a0 = s[2 * r] * v_sc[2 * (r / 2)];
      const float a1 = s[2 * r + 1] * v_sc[2 * (r / 2) + 1];
      p_hi[r] = wg::bf16x2(a0, a1);
      const float h0f = __uint_as_float(p_hi[r] << 16);
      const float h1f = __uint_as_float(p_hi[r] & 0xffff0000u);
      p_lo[r] = wg::bf16x2(a0 - h0f, a1 - h1f);   // both differences exact
    }

    // O += P V
    const uint64_t dv = wg::sw128_desc(v_addr, kTileLines * kAtomRow, 1024);
    wg::wgmma_fence();
    wg::MmaRegA<NO>::run(acc, p_hi, dv);
    wg::MmaRegA<NO>::run(acc, p_lo, dv);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::pin(acc);
    wg::pin_u32(p_hi);
    wg::pin_u32(p_lo);
  }
  cp_async::wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }

  if (nc == 1) {
    // the row group's only chunk: out = acc / max(l, 1e-30), rounded once
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (row[hh] >= n_rows) continue;
      if (p.lse != nullptr && quad == 0)
        p.lse[lse_offset(p, b, h, row[hh])] = log_sum_exp(m[hh], l[hh]);
      const float den = fmaxf(l[hh], 1e-30f);
      __nv_bfloat16* dst = p.out + row_offset(p, b, h, row[hh], HD)
                           + 2 * quad;
#pragma unroll
      for (int jj = 0; jj < NO / 8; ++jj) {
        if (8 * jj + 2 * quad < HD)
          *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
              wg::bf16x2(acc[4 * jj + 2 * hh] / den,
                         acc[4 * jj + 2 * hh + 1] / den);
      }
    }
    return;
  }

  // the chunk's (m, l, acc) of this thread's rows
  const size_t group_rows = (static_cast<size_t>(b) * p.kv_heads + h)
                            * n_rows;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] >= n_rows) continue;
    const size_t part = (group_rows + row[hh]) * p.max_chunks + chunk;
    if (quad == 0)
      *reinterpret_cast<float2*>(p.part_ml + part * 2) =
          make_float2(m[hh], l[hh]);
    float* dst = p.part_acc + part * HD + 2 * quad;
#pragma unroll
    for (int jj = 0; jj < NO / 8; ++jj) {
      if (8 * jj + 2 * quad < HD)
        *reinterpret_cast<float2*>(dst + 8 * jj) =
            make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
    }
  }

  // count this chunk in; the row group's last block merges
  __threadfence();
  __syncthreads();
  int* counter = p.counters
                 + (static_cast<size_t>(b) * p.kv_heads + h) * p.row_tiles
                 + tile;
  if (tt == 0) {
    const int last = atomicAdd(counter, 1) == nc - 1;
    if (last) *counter = 0;                   // ready for the next call
    __threadfence();
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;

  // every chunk of each row, in chunk order: out = O / max(L, 1e-30).
  // The chunks' partials are read kMergeBatch at a time, all loads of a
  // batch issued before its sums, so a thread waits on one L2 round trip
  // a batch, not one a chunk; the sums still run in chunk order.  A row's
  // M is taken once, by one thread, and shared.
  const int rows_here = min(kRows, n_rows - row0);
  for (int r = tt; r < rows_here; r += kThreads) {
    const float2* ml_g = reinterpret_cast<const float2*>(p.part_ml)
                         + (group_rows + row0 + r) * p.max_chunks;
    float mxc = kNegInf;
    for (int c0 = 0; c0 < nc; c0 += kMergeBatch) {
      float mb[kMergeBatch];
#pragma unroll
      for (int k = 0; k < kMergeBatch; ++k)
        mb[k] = c0 + k < nc ? __ldcg(&ml_g[c0 + k].x) : kNegInf;
#pragma unroll
      for (int k = 0; k < kMergeBatch; ++k) mxc = fmaxf(mxc, mb[k]);
    }
    s_max[r] = mxc;
  }
  __syncthreads();
  for (int i = tt; i < rows_here * (HD / 4); i += kThreads) {
    const int r = row0 + i / (HD / 4), col = 4 * (i % (HD / 4));
    const size_t base = (group_rows + r) * p.max_chunks;
    const float2* ml_g = reinterpret_cast<const float2*>(p.part_ml) + base;
    const float* acc_g = p.part_acc + base * HD + col;
    const float mxc = s_max[r - row0];
    float den = 0.0f;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c0 = 0; c0 < nc; c0 += kMergeBatch) {
      float2 ml[kMergeBatch];
      float4 a[kMergeBatch];
#pragma unroll
      for (int k = 0; k < kMergeBatch; ++k) {
        if (c0 + k < nc) {
          ml[k] = __ldcg(ml_g + c0 + k);
          a[k] = __ldcg(reinterpret_cast<const float4*>(
              acc_g + static_cast<size_t>(c0 + k) * HD));
        }
      }
#pragma unroll
      for (int k = 0; k < kMergeBatch; ++k) {
        if (c0 + k < nc) {
          const float w = expf(ml[k].x - mxc);
          den += ml[k].y * w;
          o.x += a[k].x * w;
          o.y += a[k].y * w;
          o.z += a[k].z * w;
          o.w += a[k].w * w;
        }
      }
    }
    if (p.lse != nullptr && col == 0)
      p.lse[lse_offset(p, b, h, r)] = log_sum_exp(mxc, den);
    den = fmaxf(den, 1e-30f);
    __nv_bfloat16* dst = p.out + row_offset(p, b, h, r, HD) + col;
    *reinterpret_cast<uint2*>(dst) = make_uint2(
        wg::bf16x2(o.x / den, o.y / den), wg::bf16x2(o.z / den, o.w / den));
  }
}

// -- host side ---------------------------------------------------------------

// Launch the kernel for a call; `stages` 1 stages each tile synchronously
// (the off walks), 2-4 keep that many tiles in flight (the ring).
template <typename S, int HD>
int launch(Params p, int batch, void* work, cudaStream_t stream) {
  using Sh = Shape<S, HD>;
  const size_t bytes = Sh::smem_bytes(p.stages);
  const int n_rows = p.n_tokens * p.groups;
  p.row_tiles = (n_rows + kRows - 1) / kRows;
  if (p.stages < 1 || p.stages > kMaxStages || bytes > 227 * 1024 ||
      batch > 65535 || static_cast<long long>(p.kv_heads) * p.row_tiles
                           > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.max_chunks = (p.n_blocks + kChunkPages - 1) / kChunkPages;
  p.part_acc = static_cast<float*>(work);
  p.part_ml = p.part_acc + static_cast<size_t>(batch) * p.kv_heads * n_rows
                               * p.max_chunks * HD;
  auto kernel = gqa_split_bf16_kernel<S, HD>;
  static size_t opted_in = 48 * 1024;
  if (bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = bytes;
  }
  const dim3 grid(p.max_chunks, p.kv_heads * p.row_tiles, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the call's pointer and shape arguments, carried through the dispatch
struct Args {
  Params p;
  int batch;
  void* work;
  cudaStream_t stream;
};

template <typename S>
int dispatch_head_dim(int head_dim, const Args& a) {
#define GQA_HD(HD)                                                          \
  case HD:                                                                  \
    return launch<S, HD>(a.p, a.batch, a.work, a.stream);
  switch (head_dim) {
    GQA_HD(16)
    GQA_HD(32)
    GQA_HD(64)
    GQA_HD(128)
    GQA_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GQA_HD
}

}  // namespace

extern "C" int gqa_core_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos, void* out, void* lse, void* work, void* counters,
    int batch,
    int n_tokens, int kv_heads, int groups, int head_dim, int page_size,
    int n_blocks, int stages, float scale, float soft_cap, int kv_dtype,
    void* stream) {
  if (batch <= 0 || n_tokens <= 0 || kv_heads <= 0 || groups <= 0
      || page_size <= 0 || n_blocks <= 0 || work == nullptr
      || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kv_load::kSame && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int32_t*>(block_tables),
                 static_cast<const int32_t*>(pos),
                 static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
                 nullptr, nullptr,
                 static_cast<int*>(counters), n_tokens, kv_heads, groups,
                 page_size, n_blocks, /*max_chunks=*/0, /*row_tiles=*/0,
                 stages, scale, soft_cap};
  const Args a{p, batch, work, static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case kv_load::kSame:
      return dispatch_head_dim<__nv_bfloat16>(head_dim, a);
    case kv_load::kInt8:
      return dispatch_head_dim<int8_t>(head_dim, a);
    case kv_load::kFp8:
      return dispatch_head_dim<__nv_fp8_e4m3>(head_dim, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
