// GQA paged attention (decode and multi-token verification) over a ring of
// page slabs filled with cp.async, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gqa_double_kernel` / `_gqa_paged_double`
// in src/repro/kernels/paged_attention.py:673 / :763 (its pallas_call at
// :803), the `pipeline="double"` walk of `paged_attention` (decode) and
// `paged_attention_verify` (verify): the TPU kernel walks a slot's block
// table inside one program and DMAs page j+1 into the second of two VMEM
// slabs while page j is scored.  It computes what the single-buffered
// kernels compute, bit for bit.  Here: for slot b, KV head h and query
// token t at position pos[b] + t (T = 1 for decode), the G query rows of
// that head attend to the lines k_pos <= pos[b] + t of the slot's pages
// (P, page, KV, hd); s = (q . k) * scale, optional tanh soft cap, online
// softmax in float32, out = acc / max(l, 1e-30).
//
// Bound on the card: bytes.  A call must read every visible KV line once
// ((pos + T) lines of 2 * hd elements per slot and KV head, plus two
// float32 scales for a quantized pool), the live table entries, q and the
// output; 4 * T * G * hd FLOPs per line is far under the ridge.  The
// `pipeline="off"` kernels (csrc/paged_attention.cu,
// csrc/paged_attention_verify.cu) sit at 38x and 56x that bound, which
// PERF.md puts on dependent loads: each stream reads its line's table
// entry, then its K/V, from global memory, one line at a time.
//
// What the ring does about it:
// * the block copies its slot's live block-table entries into shared
//   memory once, before the walk, so no K/V address waits on a table
//   read inside the loop;
// * a stage is one page of this KV head's K and V (page x hd elements
//   each, rows hd apart in shared memory, KV * hd apart in the pool);
//   `stages` (2-4) stages form a ring in dynamic shared memory, filled
//   with 16-byte `cp.async.cg` copies by all 128 threads, one commit group
//   per page; page j + stages - 1 is issued before page j is computed, so
//   up to stages - 1 pages are in flight behind the one being scored
//   (16 KB a stage at page 16, hd 128 in float32);
// * quantized pools (int8 / fp8 e4m3 codes, csrc/kv_load.cuh; the storage
//   type S is the second template parameter, as in the off kernels): a
//   stage holds the page's K and V code slabs (page x hd bytes each, hd a
//   multiple of 16 so the 16-byte copies still tile a line) and two
//   (page,) float32 scale slabs, K's and V's for head h, in the page's
//   commit group: the reference's two scale slabs on the same lookahead
//   (paged_attention.py:684-686, :704-711).  Head h's scales are a column
//   of the (P, page, KV) scale pool, KV * 4 bytes apart, which no 16-byte
//   copy gathers; each is one 4-byte `cp.async.ca` (cp_async::copy4), 2 *
//   page of them a stage (32 beside qwen3-0.6b's 32 code copies), rather
//   than copying the page's whole (page, KV) scale block: KV times the
//   bytes, and 16-byte alignment of a page's block only when page * KV is
//   a multiple of 4;
// * the compute is the off kernels' exactly: the same line-to-stream
//   assignment (stream s takes lines s, s + STREAMS, ...), the same lane
//   layout (a lane covers VEC elements of the query's dtype and, over a
//   quantized pool, reads VEC codes), the same dequantization
//   float(code) * scale at the op position of kv_load::load_line, the
//   same float32 operations in the same order and the same final merge of
//   the streams' (m, l, acc); only the loads move from global memory to
//   the ring.  So the output equals the off kernel's bit for bit at the
//   same storage (row 1 at T = 1, row 3 otherwise), as the Pallas double
//   walk equals its off walk;
// * rows: as in the verify kernel, T * G rows of any count, tiled 8 per
//   block (grid KV x B x ceil(T * G / 8)), each row with its own causal
//   limit pos + t; idle all-trash lanes read trash page 0 and stay finite.
// bf16 queries take csrc/gqa_core.cu with tiles in flight (tensor cores,
// split-K over chunks of pages), the core that the off walks call too; the
// wrapper picks it by the queries' dtype.  This source is the float32
// ring, on the CUDA cores.
//
// C interface (bound with ctypes by repro_torch/kernels/paged_attention.py):
//   int paged_attention_ring(q, k_pool, v_pool, k_scale, v_scale,
//                            block_tables, pos, out, batch, n_tokens,
//                            kv_heads, groups, head_dim, page_size,
//                            n_blocks, stages, scale, soft_cap,
//                            dtype /*0 f32*/,
//                            kv_dtype /*0 as q, 1 int8, 2 fp8 e4m3*/,
//                            stream)
// q and out are (batch, n_tokens, kv_heads, groups, head_dim); the scale
// pointers are null unless kv_dtype quantizes; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a head_dim, dtype, storage
// or stage count the kernel is not built for, or a ring that does not fit
// in shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "kv_load.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowTile = 8;   // query rows per block
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory a block may use

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

// Lane layout of one head vector (as in the off kernels) and the size of
// the streams' merge buffers.
template <typename T, int HD, int RMAX>
struct Layout {
  static constexpr int VEC = VecWidth<T>::N;
  static constexpr int LANES = (HD / VEC < 32) ? HD / VEC : 32;
  static constexpr int NV = HD / (VEC * LANES);
  static constexpr int EPL = NV * VEC;
  static constexpr int TPW = 32 / LANES;
  static constexpr int STREAMS = kWarps * TPW;
  static constexpr size_t MERGE_BYTES =
      (size_t)STREAMS * RMAX * (HD + 2) * sizeof(float);
};

// Bytes of the block-table copy at the front of dynamic shared memory
// (rounded up so the ring after it is 16-byte aligned).
__host__ __device__ inline size_t table_bytes(int n_blocks) {
  return ((size_t)n_blocks * sizeof(int32_t) + 15) / 16 * 16;
}

// Bytes of one ring stage: the K and V slabs of a page in the storage
// type, then, for a quantized pool, K's and V's (page,) float32 scales;
// rounded up to 16 so every stage starts 16-byte aligned
// (kernels/paged_attention.py::gqa_ring_stage_bytes is the same count).
template <typename S, int HD>
__host__ __device__ inline size_t stage_bytes(int page_size) {
  const size_t codes = (size_t)2 * page_size * HD * sizeof(S);
  const size_t scales =
      kv_load::Quantized<S>::value ? (size_t)2 * page_size * sizeof(float)
                                   : 0;
  return (codes + scales + 15) / 16 * 16;
}

// T: the query / output dtype, float (bf16 queries take csrc/gqa_core.cu);
// S: the pools' storage type (T, int8_t or __nv_fp8_e4m3).  RMAX: rows
// held per block (a power of two <= kRowTile, >= the rows of any tile of
// this launch).
template <typename T, typename S, int HD, int RMAX>
__global__ void __launch_bounds__(kWarps * 32)
paged_ring_kernel(const T* __restrict__ q, const S* __restrict__ k_pool,
                  const S* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ block_tables,
                  const int32_t* __restrict__ pos, T* __restrict__ out,
                  int n_tokens, int kv_heads, int groups, int page_size,
                  int n_blocks, int stages, float scale, float soft_cap) {
  using L = Layout<T, HD, RMAX>;
  constexpr int VEC = L::VEC, LANES = L::LANES, NV = L::NV, EPL = L::EPL;
  constexpr int TPW = L::TPW, STREAMS = L::STREAMS;
  constexpr bool QUANT = kv_load::Quantized<S>::value;
  constexpr int SPC = 16 / sizeof(S);   // storage elements per 16-byte copy
  constexpr int CPL = HD / SPC;         // 16-byte copies per head vector
  static_assert(HD % (VEC * LANES) == 0, "head_dim must tile the lanes");
  static_assert(HD % SPC == 0, "a head vector must tile 16-byte copies");

  // [block-table row | ring of `stages` stages: K slab, V slab (and, over
  // a quantized pool, K scales, V scales)]; after the walk the same bytes
  // hold the streams' merge buffers
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tbl = reinterpret_cast<int32_t*>(smem);
  unsigned char* ring = smem + table_bytes(n_blocks);
  const size_t stage = stage_bytes<S, HD>(page_size);

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
  const int n_pages = (n_lines + page_size - 1) / page_size;
  const int32_t* bt = block_tables + (size_t)b * n_blocks;
  for (int j = threadIdx.x; j < n_pages; j += blockDim.x) tbl[j] = bt[j];
  __syncthreads();

  const size_t line_stride = (size_t)kv_heads * HD;
  const int slab = page_size * HD;           // elements of one K or V slab
  const int slab_chunks = page_size * CPL;   // 16-byte copies per slab

  // the K slab, V slab and (quantized) K / V scales of stage st
  auto k_slab = [&](int st) {
    return reinterpret_cast<S*>(ring + (size_t)st * stage);
  };
  auto k_scales = [&](int st) {
    return reinterpret_cast<float*>(k_slab(st) + 2 * slab);
  };

  // page j of the walk into stage j % stages (one commit group per call,
  // empty past the last page)
  auto issue = [&](int j) {
    if (j < n_pages) {
      const size_t page_line = (size_t)tbl[j] * page_size;
      const size_t page_base = page_line * line_stride + (size_t)h * HD;
      S* st = k_slab(j % stages);
      for (int c = threadIdx.x; c < 2 * slab_chunks; c += blockDim.x) {
        const int is_v = c >= slab_chunks;
        const int cc = c - is_v * slab_chunks;
        const int line = cc / CPL;
        const int w = cc % CPL;
        const S* src = (is_v ? v_pool : k_pool) + page_base
                       + (size_t)line * line_stride + w * SPC;
        cp_async::copy16(st + is_v * slab + line * HD + w * SPC, src);
      }
      if constexpr (QUANT) {
        // head h's (page,) column of each (P, page, KV) scale pool
        float* ss = k_scales(j % stages);
        for (int c = threadIdx.x; c < 2 * page_size; c += blockDim.x) {
          const int is_v = c >= page_size;
          const int line = c - is_v * page_size;
          cp_async::copy4(ss + c, (is_v ? v_scale : k_scale)
                                      + (page_line + line) * kv_heads + h);
        }
      }
    }
    cp_async::commit();
  };

  for (int j = 0; j < stages - 1; ++j) issue(j);
  for (int j = 0; j < n_pages; ++j) {
    cp_async::wait_oldest(stages);
    // page j is in shared memory, and every thread is done with page j-1,
    // whose stage the next issue refills
    __syncthreads();
    issue(j + stages - 1);
    const S* ks = k_slab(j % stages);
    const S* vs = ks + slab;
    const float* kss = k_scales(j % stages);   // read only when QUANT
    const float* vss = kss + page_size;
    const int a = j * page_size;               // first line of page j
    const int e_end = min(a + page_size, n_lines);
    // this warp's line groups t0 .. t0 + TPW - 1 (t0 = warp * TPW + k *
    // STREAMS, as in the off kernel) that meet page j; warp-uniform, so
    // every lane reaches the shuffles below
    const int first = warp * TPW;
    const int ahead = a - TPW + 1 - first;
    int t0 = first + (ahead > 0 ? (ahead + STREAMS - 1) / STREAMS : 0)
                     * STREAMS;
    for (; t0 < e_end; t0 += STREAMS) {
      const int t = t0 + grp;
      const bool live = t >= a && t < e_end;   // this page's share of t
      float kf[EPL], vf[EPL];
      if (live) {
        const int off = (t - a) * HD;
        const float k_sc = QUANT ? kss[t - a] : 1.f;
        const float v_sc = QUANT ? vss[t - a] : 1.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kv_load::load_line<VEC, true>(ks + off + elem(v), k_sc,
                                        &kf[v * VEC]);
          kv_load::load_line<VEC, true>(vs + off + elem(v), v_sc,
                                        &vf[v * VEC]);
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
        for (int e = 0; e < EPL; ++e)
          acc[i][e] = acc[i][e] * alpha + p * vf[e];
        m[i] = m_new;
      }
    }
  }
  cp_async::wait<0>();
  __syncthreads();                    // the ring's bytes become the merge's

  // merge the streams' (m, l, acc) states
  float* sm_m = reinterpret_cast<float*>(smem);      // [STREAMS][RMAX]
  float* sm_l = sm_m + STREAMS * RMAX;               // [STREAMS][RMAX]
  float* sm_acc = sm_l + STREAMS * RMAX;             // [STREAMS][RMAX][HD]
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    if (sub == 0) {
      sm_m[stream * RMAX + i] = m[i];
      sm_l[stream * RMAX + i] = l[i];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(stream * RMAX + i) * HD + elem(v) + e] = acc[i][v * VEC + e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n_rows * HD; idx += blockDim.x) {
    const int i = idx / HD;
    const int d = idx % HD;
    float m_all = kNegInf;
    for (int s = 0; s < STREAMS; ++s)
      m_all = fmaxf(m_all, sm_m[s * RMAX + i]);
    float l_all = 0.f, o = 0.f;
    for (int s = 0; s < STREAMS; ++s) {
      const float w = expf(sm_m[s * RMAX + i] - m_all);
      l_all += sm_l[s * RMAX + i] * w;
      o += sm_acc[(s * RMAX + i) * HD + d] * w;
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
  int batch, n_tokens, kv_heads, groups, page_size, n_blocks, stages;
  float scale, soft_cap;
  cudaStream_t stream;
};

template <typename T, typename S, int HD, int RMAX>
int launch(const Args& a) {
  const size_t ring = table_bytes(a.n_blocks)
                      + (size_t)a.stages * stage_bytes<S, HD>(a.page_size);
  const size_t merge = Layout<T, HD, RMAX>::MERGE_BYTES;
  const size_t bytes = ring > merge ? ring : merge;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_ring_kernel<T, S, HD, RMAX>;
  static size_t opted_in = 48 * 1024;   // per instantiation
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = bytes;
  }
  const int rows = a.n_tokens * a.groups;
  const dim3 grid(a.kv_heads, a.batch, (rows + RMAX - 1) / RMAX);
  kernel<<<grid, kWarps * 32, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.ks, a.vs,
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.pos),
      static_cast<T*>(a.out), a.n_tokens, a.kv_heads, a.groups, a.page_size,
      a.n_blocks, a.stages, a.scale, a.soft_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S, int HD>
int dispatch_rows(const Args& a) {
  const int rows = a.n_tokens * a.groups;
  if (rows <= 1) return launch<T, S, HD, 1>(a);
  if (rows <= 2) return launch<T, S, HD, 2>(a);
  if (rows <= 4) return launch<T, S, HD, 4>(a);
  return launch<T, S, HD, kRowTile>(a);
}

template <typename T, typename S>
int dispatch_head_dim(int head_dim, const Args& a) {
#define PR_HD(HD)                                                           \
  case HD:                                                                  \
    return dispatch_rows<T, S, HD>(a);
  switch (head_dim) {
    PR_HD(16)
    PR_HD(32)
    PR_HD(64)
    PR_HD(128)
    PR_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PR_HD
}

template <typename T>
int dispatch_store(int kv_dtype, int head_dim, const Args& a) {
  switch (kv_dtype) {
    case kv_load::kSame:
      return dispatch_head_dim<T, T>(head_dim, a);
    case kv_load::kInt8:
      return dispatch_head_dim<T, int8_t>(head_dim, a);
    case kv_load::kFp8:
      return dispatch_head_dim<T, __nv_fp8_e4m3>(head_dim, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_attention_ring(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos, void* out, int batch, int n_tokens, int kv_heads,
    int groups, int head_dim, int page_size, int n_blocks, int stages,
    float scale, float soft_cap, int dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || n_tokens <= 0 || kv_heads <= 0 || groups <= 0
      || page_size <= 0 || n_blocks <= 0 || stages < 2 || stages > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kv_load::kSame && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), block_tables, pos, out,
               batch, n_tokens, kv_heads, groups, page_size, n_blocks, stages,
               scale, soft_cap, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_store<float>(kv_dtype, head_dim, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
