// MLA paged attention in the latent space (decode and multi-token
// verification) over a ring of line tiles filled with cp.async, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_mla_double_kernel` / `_mla_paged_double`
// in src/repro/kernels/paged_attention.py:811 / :893 (its pallas_call at
// :932), the `pipeline="double"` walk of `mla_paged_attention` (decode)
// and `mla_paged_attention_verify` (verify): the TPU kernel walks the
// block table inside one program and DMAs the next page's latent and rope
// slabs into the second of two VMEM slab pairs while the current page is
// scored; its output equals the single-buffered kernels' bit for bit.
// Here, for slot b, query token t (T = 1 for decode, at position
// pos[b] + t) and head h, in the absorbed form of DeepSeek-V2's MLA:
//
//   s[l]          = (q_lat[b,t,h] . c[l] + q_rope[b,t,h] . kr[l]) * scale
//   o_lat[b,t,h]  = softmax_l(s) @ c        over the lines l <= pos[b] + t
//
// with line l in page block_tables[b, l / page] of the latent pool c
// (P, page, r) and the rope pool kr (P, page, dr); online softmax in
// float32, out = acc / max(l, 1e-30).
//
// Bound on the card.  A call must read every visible line once, (r + dr)
// elements, the live table entries, q_lat, q_rope and the output; the
// operations, T * H * (4r + 2dr) per line, put it near the bf16 ridge at
// full width (PERF.md), so bytes and operations bound it about evenly.
//
// bf16 queries take csrc/mla_core.cu, the off walks' core, with `stages`
// tiles of a chunk in flight (at most a chunk's tiles: 2 at page 16): the
// next tile's cp.async copies run while the current one is multiplied.
// The chunk, the tiles and the merge do not depend on the stage count, so
// the output equals the off walks' bit for bit (row 4 at T = 1, row 5
// otherwise).
//
// This source is the float32 path, the CUDA-core ring below.  The
// `pipeline="off"` float32 kernels stage 16 lines at a time into float32
// shared memory synchronously: every thread loads, converts and stores,
// waits at a barrier, then computes, so no load overlaps the arithmetic.
// What the ring does about it:
// * the block copies its slot's live block-table entries into shared
//   memory once, so no line address waits on a table read in the walk;
// * a stage is one 16-line tile (`kTileLines`, the off kernels' tile: one
//   page at page 16) of RAW latent and rope lines, in the pools' own type;
//   `stages` (2-4) tiles form a ring in dynamic shared memory (above 48 KB
//   the kernel opts in with cudaFuncSetAttribute), filled with 16-byte
//   `cp.async.cg` copies, one commit group per tile; tile j + stages - 1
//   is issued before tile j is computed.  Lines past the visible ones are
//   written as zeros, as the off kernels stage them;
// * quantized pools (int8 / fp8 e4m3 codes, csrc/kv_load.cuh; the storage
//   type S is the second template parameter, as in the off kernels): a
//   stage is the tile's 16 raw code lines of latent and rope and their 16
//   latent and 16 rope float32 scales, in the tile's commit group: the
//   reference's two (page,) scale slabs on the same lookahead
//   (paged_attention.py:835-869).  A rope line at dr 8 is 8 B, so rope
//   lines copy in chunks of min(16, dr) bytes (an 8-byte `cp.async.ca`,
//   cp_async::copy8, at dr 8); each scale is one 4-byte `cp.async.ca`
//   (copy4), and a line past the visible ones gets zero codes AND a zero
//   scale, so it dequantizes to the 0.0 the off kernels stage (zero codes
//   times a stale NaN would be NaN);
// * the compute is the float32 off kernels' exactly (8 warps = 4 head
//   pairs x 2 column halves, 8 heads of one query token per block, grid
//   (B, ceil(H / 8), T)): the same partial products, butterfly
//   reduce-scatter, column-half sum, per-tile online softmax and P.V, in
//   the same order, on the same float32 values (a line is widened, and a
//   code multiplied by its line's scale, when read instead of when
//   staged; the widening is exact and the multiply is the off kernels'
//   own float(code) * scale).  So the output equals the off kernel's bit
//   for bit at the same storage.
//
// C interface (bound with ctypes by repro_torch/kernels/paged_attention.py):
//   int mla_paged_attention_ring(q_lat, q_rope, c_pool, r_pool, c_scale,
//                                r_scale, block_tables, pos, out, batch,
//                                n_tokens, n_heads, latent_dim, rope_dim,
//                                page_size, n_blocks, stages, scale,
//                                dtype /*0 f32*/,
//                                kv_dtype /*0 as q, 1 int8, 2 fp8*/, stream)
// q_lat / out are (batch, n_tokens, n_heads, latent_dim), q_rope
// (batch, n_tokens, n_heads, rope_dim); the scale pointers are null unless
// kv_dtype quantizes; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a latent / rope dim, dtype, storage or stage
// count the kernel is not built for, or a ring that does not fit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "kv_load.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kHeadsPerWarp = 2;
constexpr int kColSplits = 2;   // warps sharing a head pair, by columns
constexpr int kHeadsPerBlock = kWarps / kColSplits * kHeadsPerWarp;
constexpr int kTileLines = 16;  // lines per ring stage
constexpr float kNegInf = -1e30f;
// dynamic shared memory a block may use, beside the static s_part
constexpr size_t kMaxSmem = 227 * 1024 - kWarps * 32 * sizeof(float);
static_assert(kHeadsPerWarp * kTileLines == 32, "one score per lane");

__device__ __forceinline__ float to_float(float v) { return v; }

// Four consecutive staged elements as float32: widened, and times their
// line's scale over a quantized pool (kv_load::load_line, from shared
// memory).
template <typename S>
__device__ __forceinline__ float4 load4(const S* p, float scale) {
  float f[4];
  kv_load::load_line<4, true>(p, scale, f);
  return make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

__device__ __forceinline__ float dot4(const float* q, float4 c) {
  return q[0] * c.x + q[1] * c.y + q[2] * c.z + q[3] * c.w;
}

// Bytes of the block-table copy at the front of dynamic shared memory
// (rounded up so the ring after it is 16-byte aligned).
__host__ __device__ inline size_t table_bytes(int n_blocks) {
  return ((size_t)n_blocks * sizeof(int32_t) + 15) / 16 * 16;
}

// Bytes of one ring stage: 16 latent and 16 rope lines in the storage
// type, then, for a quantized pool, their 16 latent and 16 rope float32
// scales (a multiple of 16 at every R and DR built;
// kernels/paged_attention.py::mla_ring_stage_bytes is the same count).
template <typename S, int R, int DR>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)kTileLines * (R + DR) * sizeof(S)
         + (kv_load::Quantized<S>::value ? 2 * kTileLines * sizeof(float)
                                         : 0);
}

// T: the query / output dtype, float (bf16 queries take csrc/mla_core.cu);
// S: the pools' storage type (T, int8_t or __nv_fp8_e4m3)
template <typename T, typename S, int R, int DR>
__global__ void __launch_bounds__(kWarps * 32)
mla_ring_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                const S* __restrict__ c_pool, const S* __restrict__ r_pool,
                const float* __restrict__ c_scale,
                const float* __restrict__ r_scale,
                const int32_t* __restrict__ block_tables,
                const int32_t* __restrict__ pos, T* __restrict__ out,
                int n_tokens, int n_heads, int page_size, int n_blocks,
                int stages, float scale) {
  constexpr bool QUANT = kv_load::Quantized<S>::value;
  constexpr int LB = R * sizeof(S);    // bytes of a latent line
  constexpr int RB = DR * sizeof(S);   // bytes of a rope line
  constexpr int RC = RB < 16 ? RB : 16;  // bytes per rope-line copy
  constexpr int GC = LB / 16;          // 16-byte copies per latent line
  constexpr int GR = RB / RC;          // copies per rope line
  constexpr int CV = R / 4;            // float4 slots per latent line
  constexpr int CVS = CV / kColSplits; // float4 slots per column half
  constexpr int RV = DR / 4;           // float4 slots per rope line
  constexpr int NC = (CVS + 31) / 32;  // latent float4 slots per lane
  constexpr int NR = (RV + 31) / 32;   // rope float4 slots per lane
  constexpr size_t STAGE = stage_bytes<S, R, DR>();
  static_assert(LB % 16 == 0 && RB % RC == 0 && RC % 8 == 0,
                "lines must tile the copies");
  static_assert(STAGE % 16 == 0, "stages must stay 16-byte aligned");
  static_assert(CV % kColSplits == 0, "latent dim must split in halves");

  // [block-table row | ring of `stages` tiles: latent [16][R], rope
  // [16][DR] (and, over a quantized pool, latent scales [16], rope scales
  // [16])]
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tbl = reinterpret_cast<int32_t*>(smem);
  unsigned char* ring = smem + table_bytes(n_blocks);
  __shared__ float s_part[kWarps][32];

  const int b = blockIdx.x;
  const int tok = blockIdx.z;           // query token: limit pos + tok
  const size_t bt_row = (size_t)b * n_tokens + tok;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = warp / kColSplits;
  const int half = warp % kColSplits;
  const int h0 = blockIdx.y * kHeadsPerBlock + pair * kHeadsPerWarp;
  const int vbase = half * CVS;        // first float4 slot of this half
  const bool rope = half == 0;         // the first half adds the rope part

  // this lane's slices of its heads' queries: float4 slot vbase + lane +
  // 32 k; heads past n_heads (the last block's padding) get zeros
  float qc[kHeadsPerWarp][NC][4];
  float qr[kHeadsPerWarp][NR][4];
  float acc[kHeadsPerWarp][NC][4];
#pragma unroll
  for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
    const int h = h0 + hh;
    const T* qcb = q_lat + (bt_row * n_heads + h) * R;
    const T* qrb = q_rope + (bt_row * n_heads + h) * DR;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int v = lane + 32 * k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qc[hh][k][j] = (h < n_heads && v < CVS)
                           ? to_float(qcb[(vbase + v) * 4 + j]) : 0.f;
        acc[hh][k][j] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int v = lane + 32 * k;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qr[hh][k][j] = (rope && h < n_heads && v < RV)
                           ? to_float(qrb[v * 4 + j]) : 0.f;
    }
  }

  // online-softmax state of head (lane / kTileLines) of this warp; every
  // lane of that head's 16-lane group holds the same values
  float m_run = kNegInf, l_run = 0.f;

  // lines 0..pos+tok are visible (k_pos <= pos + tok); nothing past them
  // is read
  const int n_lines = min(pos[b] + tok + 1, n_blocks * page_size);
  const int n_tiles = (n_lines + kTileLines - 1) / kTileLines;
  const int n_pages = (n_lines + page_size - 1) / page_size;
  const int32_t* bt = block_tables + (size_t)b * n_blocks;
  for (int j = threadIdx.x; j < n_pages; j += blockDim.x) tbl[j] = bt[j];
  __syncthreads();

  // the latent lines, rope lines and (quantized) latent / rope scales of
  // stage st
  auto c_tile = [&](int st) {
    return reinterpret_cast<S*>(ring + (size_t)st * STAGE);
  };
  auto r_tile = [&](int st) { return c_tile(st) + kTileLines * R; };
  auto c_scales = [&](int st) {
    return reinterpret_cast<float*>(r_tile(st) + kTileLines * DR);
  };

  // tile j of the walk (lines 16 j .. 16 j + 15) into stage j % stages,
  // zeros past the visible lines; one commit group per call, empty past
  // the last tile
  auto issue = [&](int j) {
    if (j < n_tiles) {
      unsigned char* cs = reinterpret_cast<unsigned char*>(
          c_tile(j % stages));
      unsigned char* rs = reinterpret_cast<unsigned char*>(
          r_tile(j % stages));
      const unsigned char* cg = reinterpret_cast<const unsigned char*>(
          c_pool);
      const unsigned char* rg = reinterpret_cast<const unsigned char*>(
          r_pool);
      for (int i = threadIdx.x; i < kTileLines * (GC + GR);
           i += blockDim.x) {
        const int line = i / (GC + GR);
        const int v = i % (GC + GR);
        const int t = j * kTileLines + line;
        const bool lat = v < GC;
        unsigned char* dst = lat ? cs + line * LB + v * 16
                                 : rs + line * RB + (v - GC) * RC;
        if (t < n_lines) {
          const size_t row = (size_t)tbl[t / page_size] * page_size
                             + t % page_size;
          if (lat) {
            cp_async::copy16(dst, cg + row * LB + v * 16);
          } else if constexpr (RC == 16) {
            cp_async::copy16(dst, rg + row * RB + (v - GC) * RC);
          } else {
            cp_async::copy8(dst, rg + row * RB + (v - GC) * RC);
          }
        } else if (lat || RC == 16) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
        }
      }
      if constexpr (QUANT) {
        // each line's latent and rope scale; a zero past the visible lines
        float* ss = c_scales(j % stages);
        for (int i = threadIdx.x; i < 2 * kTileLines; i += blockDim.x) {
          const int is_r = i >= kTileLines;
          const int line = i - is_r * kTileLines;
          const int t = j * kTileLines + line;
          if (t < n_lines) {
            const size_t row = (size_t)tbl[t / page_size] * page_size
                               + t % page_size;
            cp_async::copy4(ss + i, (is_r ? r_scale : c_scale) + row);
          } else {
            ss[i] = 0.f;
          }
        }
      }
    }
    cp_async::commit();
  };

  for (int j = 0; j < stages - 1; ++j) issue(j);
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kTileLines;
    cp_async::wait_oldest(stages);
    // tile j is in shared memory, and every thread is done with tile j-1
    // (its stage and s_part), which the next issue refills
    __syncthreads();
    issue(j + stages - 1);
    const S* cs = c_tile(j % stages);
    const S* rs = r_tile(j % stages);
    const float* css = c_scales(j % stages);   // read only when QUANT
    const float* rss = css + kTileLines;

    // partial scores of (head hh, line t) over this lane's slots
    float part[kHeadsPerWarp * kTileLines];
#pragma unroll
    for (int t = 0; t < kTileLines; ++t) {
      const S* cl = cs + t * R;
      const S* rl = rs + t * DR;
      const float c_sc = QUANT ? css[t] : 1.f;
      const float r_sc = QUANT ? rss[t] : 1.f;
      float sum[kHeadsPerWarp];
#pragma unroll
      for (int hh = 0; hh < kHeadsPerWarp; ++hh) sum[hh] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int v = lane + 32 * k;
        if (v < CVS) {
          const float4 cv = load4(cl + (vbase + v) * 4, c_sc);
#pragma unroll
          for (int hh = 0; hh < kHeadsPerWarp; ++hh)
            sum[hh] += dot4(qc[hh][k], cv);
        }
      }
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int v = lane + 32 * k;
        if (rope && v < RV) {
          const float4 rv = load4(rl + v * 4, r_sc);
#pragma unroll
          for (int hh = 0; hh < kHeadsPerWarp; ++hh)
            sum[hh] += dot4(qr[hh][k], rv);
        }
      }
#pragma unroll
      for (int hh = 0; hh < kHeadsPerWarp; ++hh)
        part[hh * kTileLines + t] = sum[hh];
    }

    // butterfly reduce-scatter: after step `off` each lane keeps the half
    // its bit selects, so lane l ends with the full sum of entry l
#pragma unroll
    for (int st = 0; st < 5; ++st) {
      const int off = 16 >> st;
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < off) {
          const float send = upper ? part[i] : part[i + off];
          const float keep = upper ? part[i + off] : part[i];
          part[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
    }
    // add the column halves' partial scores, in the same order in both
    // warps of the pair, so both carry bit-identical softmax state
    s_part[warp][lane] = part[0];
    __syncthreads();
    float s_full = 0.f;
#pragma unroll
    for (int c = 0; c < kColSplits; ++c)
      s_full += s_part[pair * kColSplits + c][lane];
    const bool live = t0 + lane % kTileLines < n_lines;
    const float s = live ? s_full * scale : kNegInf;

    // online softmax over the tile, within each head's 16 lanes
    float m_tile = s;
#pragma unroll
    for (int off = kTileLines / 2; off > 0; off >>= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    const float m_new = fmaxf(m_run, m_tile);
    const float p = expf(s - m_new);
    float p_sum = p;
#pragma unroll
    for (int off = kTileLines / 2; off > 0; off >>= 1)
      p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + p_sum;
    m_run = m_new;

    // acc[hh] = acc[hh] * alpha[hh] + sum_t p[hh][t] * c[t]
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      const float a = __shfl_sync(0xffffffffu, alpha, hh * kTileLines);
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) acc[hh][k][j2] *= a;
    }
#pragma unroll
    for (int t = 0; t < kTileLines; ++t) {
      float ph[kHeadsPerWarp];
#pragma unroll
      for (int hh = 0; hh < kHeadsPerWarp; ++hh)
        ph[hh] = __shfl_sync(0xffffffffu, p, hh * kTileLines + t);
      const S* cl = cs + t * R;
      const float c_sc = QUANT ? css[t] : 1.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int v = lane + 32 * k;
        if (v < CVS) {
          const float4 cv = load4(cl + (vbase + v) * 4, c_sc);
#pragma unroll
          for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
            acc[hh][k][0] += ph[hh] * cv.x;
            acc[hh][k][1] += ph[hh] * cv.y;
            acc[hh][k][2] += ph[hh] * cv.z;
            acc[hh][k][3] += ph[hh] * cv.w;
          }
        }
      }
    }
  }
  cp_async::wait<0>();

#pragma unroll
  for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
    const float l_h = __shfl_sync(0xffffffffu, l_run, hh * kTileLines);
    const float inv = 1.f / fmaxf(l_h, 1e-30f);
    const int h = h0 + hh;
    if (h >= n_heads) continue;
    T* ob = out + (bt_row * n_heads + h) * R + vbase * 4;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int v = lane + 32 * k;
      if (v < CVS) {
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2)
          store_val(ob + v * 4 + j2, acc[hh][k][j2] * inv);
      }
    }
  }
}

// the kernel's pointer and shape arguments, carried through the dispatch
struct Args {
  const void* ql;
  const void* qr;
  const void* c;
  const void* r;
  const float* cs;
  const float* rs;
  const void* bt;
  const void* pos;
  void* out;
  int batch, n_tokens, n_heads, page_size, n_blocks, stages;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename S, int R, int DR>
int launch(const Args& a) {
  const size_t bytes = table_bytes(a.n_blocks)
                       + (size_t)a.stages * stage_bytes<S, R, DR>();
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mla_ring_kernel<T, S, R, DR>;
  static size_t opted_in = 48 * 1024 - kWarps * 32 * sizeof(float);
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = bytes;
  }
  const dim3 grid(a.batch, (a.n_heads + kHeadsPerBlock - 1) / kHeadsPerBlock,
                  a.n_tokens);
  kernel<<<grid, kWarps * 32, bytes, a.stream>>>(
      static_cast<const T*>(a.ql), static_cast<const T*>(a.qr),
      static_cast<const S*>(a.c), static_cast<const S*>(a.r), a.cs, a.rs,
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.pos),
      static_cast<T*>(a.out), a.n_tokens, a.n_heads, a.page_size,
      a.n_blocks, a.stages, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S, int R>
int dispatch_rope(int rope_dim, const Args& a) {
#define MLA_DR(DR)                                                          \
  case DR:                                                                  \
    return launch<T, S, R, DR>(a);
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

template <typename T, typename S>
int dispatch_latent(int latent_dim, int rope_dim, const Args& a) {
#define MLA_R(R)                                                            \
  case R:                                                                   \
    return dispatch_rope<T, S, R>(rope_dim, a);
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

template <typename T>
int dispatch_store(int kv_dtype, int latent_dim, int rope_dim,
                   const Args& a) {
  switch (kv_dtype) {
    case kv_load::kSame:
      return dispatch_latent<T, T>(latent_dim, rope_dim, a);
    case kv_load::kInt8:
      return dispatch_latent<T, int8_t>(latent_dim, rope_dim, a);
    case kv_load::kFp8:
      return dispatch_latent<T, __nv_fp8_e4m3>(latent_dim, rope_dim, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mla_paged_attention_ring(
    const void* q_lat, const void* q_rope, const void* c_pool,
    const void* r_pool, const void* c_scale, const void* r_scale,
    const void* block_tables, const void* pos, void* out, int batch,
    int n_tokens, int n_heads, int latent_dim, int rope_dim, int page_size,
    int n_blocks, int stages, float scale, int dtype, int kv_dtype,
    void* stream) {
  if (batch <= 0 || n_tokens <= 0 || n_heads <= 0 || page_size <= 0
      || n_blocks <= 0 || stages < 2 || stages > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kv_load::kSame && (c_scale == nullptr || r_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_lat, q_rope, c_pool, r_pool,
               static_cast<const float*>(c_scale),
               static_cast<const float*>(r_scale), block_tables, pos, out,
               batch, n_tokens, n_heads, page_size, n_blocks, stages, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return dispatch_store<float>(kv_dtype, latent_dim, rope_dim, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
