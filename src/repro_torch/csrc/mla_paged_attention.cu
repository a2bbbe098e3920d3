// MLA paged-attention decode in the latent space for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mla_paged_decode_kernel` /
// `mla_paged_attention` in src/repro/kernels/paged_attention.py.  For every
// decode slot b and head h, in the absorbed (latent) form of DeepSeek-V2's
// Multi-head Latent Attention:
//
//   s[t]        = (q_lat[b,h] . c[t] + q_rope[b,h] . kr[t]) * scale
//   o_lat[b,h]  = softmax_t(s) @ c          over the live lines t <= pos[b]
//
// where line t of the slot lives in physical page block_tables[b, t / page]
// of the latent pool c (P, page, r) and the rope pool kr (P, page, dr).
// Online softmax in float32; out = acc / max(l, 1e-30).
//
// Bound on the card.  One call reads every live line once, (r + dr)
// elements, plus q and the output; it does H * (4r + 2dr) FLOPs per line.
// At DeepSeek-V2's width (H 128, r 512, dr 64) that is ~242 FLOP per byte
// of line in bf16, near the H100's bf16 tensor-core ridge (~295), so the
// least time is about even between bytes and operations (0.57 us vs
// 0.19 us at 4 slots x ~680 lines).
//
// bf16 queries take csrc/mla_core.cu (wgmma with 64 heads as M, split-K
// over chunks of pages merged in chunk order), the core that the verify
// walk and the ring call too; the wrapper picks it by the queries' dtype.
//
// This source is the float32 path, on the CUDA cores in full float32.  Why
// the heads are split.  The Pallas kernel keeps one slot's whole (H, r)
// float32 accumulator in VMEM: 128 x 512 x 4 = 256 KB at full width, more
// than the 227 KB of shared memory a Hopper block can use.  So the grid is
// (B, ceil(H / 8)): each block owns 8 heads of one slot, whose
// accumulators (16 KB) live in registers.  The 8 warps are 4 head pairs x
// 2 column halves: a warp holds 2 heads' queries and accumulators for half
// the latent columns, which keeps a thread's registers at r = 512 under
// the 255 limit while each staged line is still read once per 2 heads.
// * each block reads its own block-table row and position (no scalar
//   prefetch on a GPU) and walks only the slot's live lines, 16 at a
//   time; the 256 threads stage those lines into shared memory once, with
//   coalesced 16-byte loads converted to float32, for all 8 heads;
// * a warp's 32 lanes split its column half; each lane forms partial dot
//   products for its 2 heads x 16 lines, one butterfly reduce-scatter
//   (31 shuffles) leaves lane l with the partial score of (head l / 16,
//   line l % 16), and the two column halves add theirs through shared
//   memory (the rope part rides with the first half);
// * the 16 lanes of a head reduce the tile's max and sum, carry (m, l)
//   across tiles (both halves compute the same values), and broadcast p
//   to the lanes that own acc columns;
// * nothing crosses blocks; idle lanes (every entry trash page 0, pos 0)
//   read one trash line and give finite output.
// Quantized pools (int8 / fp8 e4m3 codes with float32 scales (P, page)
// for the latent and the rope pool, csrc/kv_load.cuh): the pools' storage
// type is the second template parameter; staging loads 8 codes per vector
// and writes float(code) * scale, the line's scale, into the float32 tile,
// the op order of the `quantized` branch of the Pallas
// `_mla_paged_decode_kernel`; lines past the live ones stay zeros.  The
// line shrinks to r + dr + 8 bytes.
//
// C interface (bound with ctypes by repro_torch/kernels/paged_attention.py):
//   int mla_paged_attention_decode(q_lat, q_rope, c_pool, r_pool, c_scale,
//                                  r_scale, block_tables, pos, out, batch,
//                                  n_heads, latent_dim, rope_dim, page_size,
//                                  n_blocks, scale, dtype /*0 f32*/,
//                                  kv_dtype /*0 as q, 1 int8, 2 fp8*/,
//                                  stream)
// (the scale pointers are null unless kv_dtype quantizes) returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// latent / rope dim or dtype the kernel is not built for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_load.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kHeadsPerWarp = 2;
constexpr int kColSplits = 2;   // warps sharing a head pair, by columns
constexpr int kHeadsPerBlock = kWarps / kColSplits * kHeadsPerWarp;
constexpr int kTileLines = 16;  // lines staged per step
constexpr float kNegInf = -1e30f;
static_assert(kHeadsPerWarp * kTileLines == 32, "one score per lane");

__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

__device__ __forceinline__ float dot4(const float* q, float4 c) {
  return q[0] * c.x + q[1] * c.y + q[2] * c.z + q[3] * c.w;
}

// T: the query / output dtype, float (bf16 queries take csrc/mla_core.cu);
// S: the pools' storage type (T, int8_t or __nv_fp8_e4m3)
template <typename T, typename S, int R, int DR>
__global__ void __launch_bounds__(kWarps * 32)
mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const S* __restrict__ c_pool, const S* __restrict__ r_pool,
                  const float* __restrict__ c_scale,
                  const float* __restrict__ r_scale,
                  const int32_t* __restrict__ block_tables,
                  const int32_t* __restrict__ pos, T* __restrict__ out,
                  int n_heads, int page_size, int n_blocks, float scale) {
  constexpr int VG = kv_load::StageVec<S>::N;  // elements per line load
  constexpr int GC = R / VG;           // global vectors per latent line
  constexpr int GR = DR / VG;          // global vectors per rope line
  constexpr int CV = R / 4;            // float4 slots per latent line
  constexpr int CVS = CV / kColSplits; // float4 slots per column half
  constexpr int RV = DR / 4;           // float4 slots per rope line
  constexpr int NC = (CVS + 31) / 32;  // latent float4 slots per lane
  constexpr int NR = (RV + 31) / 32;   // rope float4 slots per lane
  static_assert(R % VG == 0 && DR % VG == 0, "dims must tile the loads");
  static_assert(CV % kColSplits == 0, "latent dim must split in halves");

  __shared__ __align__(16) float c_s[kTileLines][R];
  __shared__ __align__(16) float r_s[kTileLines][DR];
  __shared__ float s_part[kWarps][32];

  const int b = blockIdx.x;
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
    const T* qcb = q_lat + ((size_t)b * n_heads + h) * R;
    const T* qrb = q_rope + ((size_t)b * n_heads + h) * DR;
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

  // lines 0..pos are live (k_pos <= pos); nothing past them is read
  const int n_lines = min(pos[b] + 1, n_blocks * page_size);
  const int32_t* bt = block_tables + (size_t)b * n_blocks;

  for (int t0 = 0; t0 < n_lines; t0 += kTileLines) {
    // stage lines t0 .. t0+15 (zeros past the live ones) as float32,
    // dequantized with their line's scale when the pools are quantized
    for (int i = threadIdx.x; i < kTileLines * (GC + GR); i += blockDim.x) {
      const int line = i / (GC + GR);
      const int v = i % (GC + GR);
      const int t = t0 + line;
      float f[VG];
      if (t < n_lines) {
        const int page = __ldg(bt + t / page_size);
        const size_t row = (size_t)page * page_size + t % page_size;
        if (v < GC)
          kv_load::load_line<VG>(c_pool + row * R + v * VG,
                                 kv_load::line_scale<S>(c_scale, row), f);
        else
          kv_load::load_line<VG>(r_pool + row * DR + (v - GC) * VG,
                                 kv_load::line_scale<S>(r_scale, row), f);
      } else {
#pragma unroll
        for (int j = 0; j < VG; ++j) f[j] = 0.f;
      }
      float* dst = v < GC ? &c_s[line][v * VG] : &r_s[line][(v - GC) * VG];
#pragma unroll
      for (int j = 0; j < VG / 4; ++j)
        reinterpret_cast<float4*>(dst)[j] =
            make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
    }
    __syncthreads();

    // partial scores of (head hh, line t) over this lane's slots
    float part[kHeadsPerWarp * kTileLines];
#pragma unroll
    for (int t = 0; t < kTileLines; ++t) {
      const float4* cl = reinterpret_cast<const float4*>(c_s[t]);
      const float4* rl = reinterpret_cast<const float4*>(r_s[t]);
      float sum[kHeadsPerWarp];
#pragma unroll
      for (int hh = 0; hh < kHeadsPerWarp; ++hh) sum[hh] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int v = lane + 32 * k;
        if (v < CVS) {
          const float4 cv = cl[vbase + v];
#pragma unroll
          for (int hh = 0; hh < kHeadsPerWarp; ++hh)
            sum[hh] += dot4(qc[hh][k], cv);
        }
      }
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int v = lane + 32 * k;
        if (rope && v < RV) {
          const float4 rv = rl[v];
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
        for (int j = 0; j < 4; ++j) acc[hh][k][j] *= a;
    }
#pragma unroll
    for (int t = 0; t < kTileLines; ++t) {
      float ph[kHeadsPerWarp];
#pragma unroll
      for (int hh = 0; hh < kHeadsPerWarp; ++hh)
        ph[hh] = __shfl_sync(0xffffffffu, p, hh * kTileLines + t);
      const float4* cl = reinterpret_cast<const float4*>(c_s[t]);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int v = lane + 32 * k;
        if (v < CVS) {
          const float4 cv = cl[vbase + v];
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
    __syncthreads();  // the next tile overwrites the staged lines
  }

#pragma unroll
  for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
    const float l_h = __shfl_sync(0xffffffffu, l_run, hh * kTileLines);
    const float inv = 1.f / fmaxf(l_h, 1e-30f);
    const int h = h0 + hh;
    if (h >= n_heads) continue;
    T* ob = out + ((size_t)b * n_heads + h) * R + vbase * 4;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int v = lane + 32 * k;
      if (v < CVS) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store_val(ob + v * 4 + j, acc[hh][k][j] * inv);
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
  int batch, n_heads, page_size, n_blocks;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename S, int R, int DR>
int launch(const Args& a) {
  const dim3 grid(a.batch,
                  (a.n_heads + kHeadsPerBlock - 1) / kHeadsPerBlock);
  mla_decode_kernel<T, S, R, DR><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.ql), static_cast<const T*>(a.qr),
      static_cast<const S*>(a.c), static_cast<const S*>(a.r), a.cs, a.rs,
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.pos),
      static_cast<T*>(a.out), a.n_heads, a.page_size, a.n_blocks, a.scale);
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

extern "C" int mla_paged_attention_decode(
    const void* q_lat, const void* q_rope, const void* c_pool,
    const void* r_pool, const void* c_scale, const void* r_scale,
    const void* block_tables, const void* pos, void* out, int batch,
    int n_heads, int latent_dim, int rope_dim, int page_size,
    int n_blocks, float scale, int dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || n_heads <= 0 || page_size <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kv_load::kSame && (c_scale == nullptr || r_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_lat, q_rope, c_pool, r_pool,
               static_cast<const float*>(c_scale),
               static_cast<const float*>(r_scale), block_tables, pos, out,
               batch, n_heads, page_size, n_blocks, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return dispatch_store<float>(kv_dtype, latent_dim, rope_dim, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
