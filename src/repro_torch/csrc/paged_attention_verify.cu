// GQA paged-attention multi-token verification for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_verify_kernel` /
// `paged_attention_verify` in src/repro/kernels/paged_attention.py: the
// speculative-decoding verify step scores T = k + 1 query tokens per slot
// (the last committed token and k drafts) in one pass over the slot's KV
// history.  Query token t of slot b sits at position pos[b] + t and sees
// the lines k_pos <= pos[b] + t; for each KV head h its G query heads are
// the rows r = t * G + g of a (T * G, hd) slab, as in the Pallas kernel.
// s = (q . k) * scale, optional tanh soft cap, online softmax in float32,
// out = acc / max(l, 1e-30).
//
// Bound on the card: bytes.  One call must read every live KV line once
// ((pos + T) lines of 2 * hd elements per slot and KV head) plus q and the
// output; the arithmetic is 4 * hd FLOPs per (row, visible line), at most
// 4 * T * G * hd per line: 2.5 KFLOP per 512 B line at qwen3-14b's T = 5,
// G = 5, hd 128 in bf16, ~5 FLOP/B, far under the ridge.
//
// Design, simple first (the decode kernel csrc/paged_attention.cu with
// per-row causal limits):
// * the decode kernel holds at most 8 query rows per KV head in registers;
//   verify has T * G of them (25 on qwen3-14b at k = 4), so the grid is
//   (KV heads, slots, ceil(T * G / 8)) and each block owns a tile of up to
//   8 consecutive rows of one (slot, KV head);
// * a block reads its own block-table row and position and walks lines
//   0 .. pos + t_max of its tile (t_max: the last draft token among its
//   rows), so nothing past the tile's furthest limit is read; every row
//   keeps its own limit pos + t, and a line past it never enters that
//   row's softmax;
// * lines past the slot's backed pages (table entries 0, the trash page)
//   are read and masked by position exactly as the plain version does;
// * within a block, lane groups are independent online-softmax streams
//   over the lines (16-byte loads, one head vector per group), merged in
//   shared memory at the end, as in the decode kernel;
// * the row tiles of one (slot, KV head) each read the slot's lines; the
//   repeats come from L2 (a slot's K/V per layer is at most a few MB).
// With T = 1 this is the decode kernel's arithmetic, in the same order.
// Quantized pools (int8 / fp8 e4m3 codes with float32 scales (P, page,
// KV)) take the decode kernel's scale branch (csrc/kv_load.cuh): VEC codes
// per lane vector, the line's K and V scales read once per stream, each
// element dequantized as float(code) * scale before the dot product, as
// in the Pallas kernel's `quantized` branch of `_paged_verify_kernel`.
// bf16 queries take csrc/gqa_core.cu (tensor cores for the (T * G) x page
// score tile, split-K over chunks of pages), which the decode walk and the
// ring call too; the wrapper picks it by the queries' dtype.  This source
// is the float32 path, on the CUDA cores.
//
// C interface (bound with ctypes by repro_torch/kernels/paged_attention.py):
//   int paged_attention_verify(q, k_pool, v_pool, k_scale, v_scale,
//                              block_tables, pos, out, batch, n_tokens,
//                              kv_heads, groups, head_dim, page_size,
//                              n_blocks, scale, soft_cap,
//                              dtype /*0 f32*/,
//                              kv_dtype /*0 as q, 1 int8, 2 fp8 e4m3*/,
//                              stream)
// q and out are (batch, n_tokens, kv_heads, groups, head_dim); the scale
// pointers are null unless kv_dtype quantizes; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a head_dim or dtype the
// kernel is not built for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_load.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowTile = 8;   // query rows per block
constexpr float kNegInf = -1e30f;

// elements of the query's dtype per lane vector (16 bytes of T)
template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

// T: the query / output dtype, float (bf16 queries take csrc/gqa_core.cu);
// S: the pools' storage type (T, int8_t or __nv_fp8_e4m3); RMAX: rows
// held per block (a power of two <= kRowTile, >= the rows of any tile of
// this launch).
template <typename T, typename S, int HD, int RMAX>
__global__ void __launch_bounds__(kWarps * 32)
paged_verify_kernel(const T* __restrict__ q, const S* __restrict__ k_pool,
                    const S* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    int n_tokens, int kv_heads, int groups, int page_size,
                    int n_blocks, float scale, float soft_cap) {
  constexpr int VEC = VecWidth<T>::N;
  constexpr int LANES = (HD / VEC < 32) ? HD / VEC : 32;  // lanes per line
  constexpr int NV = HD / (VEC * LANES);                  // vectors per lane
  constexpr int EPL = NV * VEC;                           // elems per lane
  constexpr int TPW = 32 / LANES;                         // streams per warp
  constexpr int STREAMS = kWarps * TPW;
  static_assert(HD % (VEC * LANES) == 0, "head_dim must tile the lanes");

  __shared__ float sm_m[STREAMS][RMAX];
  __shared__ float sm_l[STREAMS][RMAX];
  __shared__ float sm_acc[STREAMS][RMAX][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * RMAX;             // first row of the tile
  const int n_rows = min(RMAX, n_tokens * groups - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LANES;       // stream within the warp
  const int sub = lane % LANES;       // lane within the stream
  const int stream = warp * TPW + grp;

  // element offset of this lane's v-th vector within a head vector
  auto elem = [&](int v) { return (v * LANES + sub) * VEC; };
  // q / out offset of tile row i: row r = t * G + g of (slot b, head h)
  auto row_off = [&](int i) {
    const int r = row0 + i;
    const int t = r / groups;
    const int g = r % groups;
    return ((((size_t)b * n_tokens + t) * kv_heads + h) * groups + g) * HD;
  };

  const int p0 = pos[b];
  float qr[RMAX][EPL];
  int lim[RMAX];                      // last visible line of each row
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    lim[i] = i < n_rows ? p0 + (row0 + i) / groups : -1;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (i < n_rows) {
        kv_load::widen<VEC>(q + row_off(i) + elem(v), &qr[i][v * VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[i][v * VEC + e] = 0.f;
      }
    }
  }

  float m[RMAX], l[RMAX], acc[RMAX][EPL];
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  // lines 0 .. pos + t_max are visible to some row of the tile; nothing
  // past them is read
  const int n_lines = min(p0 + (row0 + n_rows - 1) / groups + 1,
                          n_blocks * page_size);
  const int32_t* bt = block_tables + (size_t)b * n_blocks;
  const size_t line_stride = (size_t)kv_heads * HD;

  // warp-uniform trip count: every lane reaches the shuffles below
  for (int t0 = warp * TPW; t0 < n_lines; t0 += STREAMS) {
    const int t = t0 + grp;
    const bool live = t < n_lines;
    float kf[EPL], vf[EPL];
    if (live) {
      const int page = __ldg(bt + t / page_size);
      const size_t line = (size_t)page * page_size + t % page_size;
      const size_t base = line * line_stride + (size_t)h * HD;
      const float ks = kv_load::line_scale<S>(k_scale, line * kv_heads + h);
      const float vs = kv_load::line_scale<S>(v_scale, line * kv_heads + h);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        kv_load::load_line<VEC>(k_pool + base + elem(v), ks, &kf[v * VEC]);
        kv_load::load_line<VEC>(v_pool + base + elem(v), vs, &vf[v * VEC]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
    }
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      if (i >= n_rows) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qr[i][e] * kf[e];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (!live || t > lim[i]) continue;     // k_pos <= pos + t_row
      s *= scale;
      if (soft_cap > 0.f) s = tanhf(s / soft_cap) * soft_cap;
      const float m_new = fmaxf(m[i], s);
      const float alpha = expf(m[i] - m_new);
      const float p = expf(s - m_new);
      l[i] = l[i] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] = acc[i][e] * alpha + p * vf[e];
      m[i] = m_new;
    }
  }

  // merge the streams' (m, l, acc) states
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    if (sub == 0) {
      sm_m[stream][i] = m[i];
      sm_l[stream][i] = l[i];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[stream][i][elem(v) + e] = acc[i][v * VEC + e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n_rows * HD; idx += blockDim.x) {
    const int i = idx / HD;
    const int d = idx % HD;
    float m_all = kNegInf;
    for (int s = 0; s < STREAMS; ++s) m_all = fmaxf(m_all, sm_m[s][i]);
    float l_all = 0.f, o = 0.f;
    for (int s = 0; s < STREAMS; ++s) {
      const float w = expf(sm_m[s][i] - m_all);
      l_all += sm_l[s][i] * w;
      o += sm_acc[s][i][d] * w;
    }
    store_val(out + row_off(i) + d, o / fmaxf(l_all, 1e-30f));
  }
}

// the kernel's pointer and shape arguments, carried through the dispatch
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const void* bt;
  const void* pos;
  void* out;
  int batch, n_tokens, kv_heads, groups, page_size, n_blocks;
  float scale, soft_cap;
  cudaStream_t stream;
};

template <typename T, typename S, int HD, int RMAX>
void launch(const Args& a) {
  const int rows = a.n_tokens * a.groups;
  const dim3 grid(a.kv_heads, a.batch, (rows + RMAX - 1) / RMAX);
  paged_verify_kernel<T, S, HD, RMAX><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.ks, a.vs,
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.pos),
      static_cast<T*>(a.out), a.n_tokens, a.kv_heads, a.groups, a.page_size,
      a.n_blocks, a.scale, a.soft_cap);
}

template <typename T, typename S, int HD>
bool dispatch_rows(const Args& a) {
#define PV_LAUNCH(RM) launch<T, S, HD, RM>(a)
  const int rows = a.n_tokens * a.groups;
  if (rows <= 1) { PV_LAUNCH(1); return true; }
  if (rows <= 2) { PV_LAUNCH(2); return true; }
  if (rows <= 4) { PV_LAUNCH(4); return true; }
  PV_LAUNCH(kRowTile);
  return true;
#undef PV_LAUNCH
}

template <typename T, typename S>
bool dispatch_head_dim(int head_dim, const Args& a) {
#define PV_HD(HD)                                                           \
  case HD:                                                                  \
    return dispatch_rows<T, S, HD>(a);
  switch (head_dim) {
    PV_HD(16)
    PV_HD(32)
    PV_HD(64)
    PV_HD(128)
    PV_HD(256)
    default:
      return false;
  }
#undef PV_HD
}

template <typename T>
bool dispatch_store(int kv_dtype, int head_dim, const Args& a) {
  switch (kv_dtype) {
    case kv_load::kSame:
      return dispatch_head_dim<T, T>(head_dim, a);
    case kv_load::kInt8:
      return dispatch_head_dim<T, int8_t>(head_dim, a);
    case kv_load::kFp8:
      return dispatch_head_dim<T, __nv_fp8_e4m3>(head_dim, a);
    default:
      return false;
  }
}

}  // namespace

extern "C" int paged_attention_verify(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos, void* out, int batch, int n_tokens, int kv_heads,
    int groups, int head_dim, int page_size, int n_blocks, float scale,
    float soft_cap, int dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || n_tokens <= 0 || kv_heads <= 0 || groups <= 0
      || page_size <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kv_load::kSame && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), block_tables, pos, out,
               batch, n_tokens, kv_heads, groups, page_size, n_blocks, scale,
               soft_cap, static_cast<cudaStream_t>(stream)};
  const bool ok = dtype == 0 && dispatch_store<float>(kv_dtype, head_dim, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
