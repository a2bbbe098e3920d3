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
// ((pos + T) lines of 2 * hd elements per slot and KV head), the live
// table entries, q and the output; 4 * T * G * hd FLOPs per line is far
// under the ridge.  The `pipeline="off"` kernels (csrc/paged_attention.cu,
// csrc/paged_attention_verify.cu) sit at 38x and 56x that bound, which
// PERF.md puts on dependent loads: each stream reads its line's table
// entry, then its K/V, from global memory, one line at a time.
//
// What the ring does about it:
// * the block copies its slot's live block-table entries into shared
//   memory once, before the walk, so no K/V address waits on a table
//   read inside the loop;
// * a page slab is one page of this KV head's K and V (page x hd elements
//   each, rows hd apart in shared memory, KV * hd apart in the pool);
//   `stages` (2-4) slabs form a ring in dynamic shared memory, filled with
//   16-byte `cp.async.cg` copies by all 128 threads, one commit group per
//   page; page j + stages - 1 is issued before page j is computed, so up
//   to stages - 1 pages are in flight behind the one being scored
//   (8 KB a slab at qwen3-0.6b: page 16, hd 128, bf16);
// * the compute is the off kernels' exactly: the same line-to-stream
//   assignment (stream s takes lines s, s + STREAMS, ...), in the same
//   order, with the same float32 operations and the same final merge of
//   the streams' (m, l, acc); only the loads move from global memory to
//   the ring.  So the output equals the off kernel's bit for bit (row 1
//   at T = 1, row 3 otherwise), as the Pallas double walk equals its off
//   walk;
// * rows: as in the verify kernel, T * G rows of any count, tiled 8 per
//   block (grid KV x B x ceil(T * G / 8)), each row with its own causal
//   limit pos + t; idle all-trash lanes read trash page 0 and stay finite.
// Split-K over pages and tensor cores for the (T * G) x page score tile
// are later work; so are int8/fp8 scale slabs (the wrapper refuses them).
//
// C interface (bound with ctypes by repro_torch/kernels/paged_attention.py):
//   int paged_attention_ring(q, k_pool, v_pool, block_tables, pos, out,
//                            batch, n_tokens, kv_heads, groups, head_dim,
//                            page_size, n_blocks, stages, scale, soft_cap,
//                            dtype /*0 f32, 1 bf16*/, stream)
// q and out are (batch, n_tokens, kv_heads, groups, head_dim); returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head_dim, dtype or stage count the kernel is not built for, or a ring
// that does not fit in shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowTile = 8;   // query rows per block
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory a block may use

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// 16-byte global load of VecWidth<T>::N elements, widened to float.
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The same 16 bytes from a ring slab in shared memory.
__device__ __forceinline__ void load_vec_shared(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

__device__ __forceinline__ void load_vec_shared(const __nv_bfloat16* p,
                                                float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// RMAX: rows held per block (a power of two <= kRowTile, >= the rows of
// any tile of this launch).
template <typename T, int HD, int RMAX>
__global__ void __launch_bounds__(kWarps * 32)
paged_ring_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int32_t* __restrict__ block_tables,
                  const int32_t* __restrict__ pos, T* __restrict__ out,
                  int n_tokens, int kv_heads, int groups, int page_size,
                  int n_blocks, int stages, float scale, float soft_cap) {
  using L = Layout<T, HD, RMAX>;
  constexpr int VEC = L::VEC, LANES = L::LANES, NV = L::NV, EPL = L::EPL;
  constexpr int TPW = L::TPW, STREAMS = L::STREAMS;
  constexpr int CPL = HD / VEC;       // 16-byte chunks per head vector
  static_assert(HD % (VEC * LANES) == 0, "head_dim must tile the lanes");

  // [block-table row | ring of `stages` (K slab, V slab) pairs]; after the
  // walk the same bytes hold the streams' merge buffers
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tbl = reinterpret_cast<int32_t*>(smem);
  T* ring = reinterpret_cast<T*>(smem + table_bytes(n_blocks));

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
        load_vec(q + row_off(i) + elem(v), &qr[i][v * VEC]);
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

  // page j of the walk into stage j % stages (one commit group per call,
  // empty past the last page)
  auto issue = [&](int j) {
    if (j < n_pages) {
      const size_t page_base =
          (size_t)tbl[j] * page_size * line_stride + (size_t)h * HD;
      T* st = ring + (size_t)(j % stages) * 2 * slab;
      for (int c = threadIdx.x; c < 2 * slab_chunks; c += blockDim.x) {
        const int is_v = c >= slab_chunks;
        const int cc = c - is_v * slab_chunks;
        const int line = cc / CPL;
        const int w = cc % CPL;
        const T* src = (is_v ? v_pool : k_pool) + page_base
                       + (size_t)line * line_stride + w * VEC;
        cp_async::copy16(st + is_v * slab + line * HD + w * VEC, src);
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
    const T* ks = ring + (size_t)(j % stages) * 2 * slab;
    const T* vs = ks + slab;
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
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          load_vec_shared(ks + off + elem(v), &kf[v * VEC]);
          load_vec_shared(vs + off + elem(v), &vf[v * VEC]);
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

template <typename T, int HD, int RMAX>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* pos, void* out, int batch, int n_tokens, int kv_heads,
           int groups, int page_size, int n_blocks, int stages, float scale,
           float soft_cap, cudaStream_t stream) {
  const size_t ring = table_bytes(n_blocks)
                      + (size_t)stages * 2 * page_size * HD * sizeof(T);
  const size_t merge = Layout<T, HD, RMAX>::MERGE_BYTES;
  const size_t bytes = ring > merge ? ring : merge;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_ring_kernel<T, HD, RMAX>;
  static size_t opted_in = 48 * 1024;   // per instantiation
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = bytes;
  }
  const int rows = n_tokens * groups;
  const dim3 grid(kv_heads, batch, (rows + RMAX - 1) / RMAX);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), n_tokens,
      kv_heads, groups, page_size, n_blocks, stages, scale, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_rows(const void* q, const void* k, const void* v, const void* bt,
                  const void* pos, void* out, int batch, int n_tokens,
                  int kv_heads, int groups, int page_size, int n_blocks,
                  int stages, float scale, float soft_cap,
                  cudaStream_t stream) {
#define PR_LAUNCH(RM)                                                       \
  return launch<T, HD, RM>(q, k, v, bt, pos, out, batch, n_tokens,          \
                           kv_heads, groups, page_size, n_blocks, stages,   \
                           scale, soft_cap, stream)
  const int rows = n_tokens * groups;
  if (rows <= 1) PR_LAUNCH(1);
  if (rows <= 2) PR_LAUNCH(2);
  if (rows <= 4) PR_LAUNCH(4);
  PR_LAUNCH(kRowTile);
#undef PR_LAUNCH
}

template <typename T>
int dispatch_head_dim(int head_dim, const void* q, const void* k,
                      const void* v, const void* bt, const void* pos,
                      void* out, int batch, int n_tokens, int kv_heads,
                      int groups, int page_size, int n_blocks, int stages,
                      float scale, float soft_cap, cudaStream_t stream) {
#define PR_HD(HD)                                                           \
  case HD:                                                                  \
    return dispatch_rows<T, HD>(q, k, v, bt, pos, out, batch, n_tokens,     \
                                kv_heads, groups, page_size, n_blocks,      \
                                stages, scale, soft_cap, stream);
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

}  // namespace

extern "C" int paged_attention_ring(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* pos, void* out, int batch,
    int n_tokens, int kv_heads, int groups, int head_dim, int page_size,
    int n_blocks, int stages, float scale, float soft_cap, int dtype,
    void* stream) {
  if (batch <= 0 || n_tokens <= 0 || kv_heads <= 0 || groups <= 0
      || page_size <= 0 || n_blocks <= 0 || stages < 2 || stages > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(head_dim, q, k_pool, v_pool,
                                    block_tables, pos, out, batch, n_tokens,
                                    kv_heads, groups, page_size, n_blocks,
                                    stages, scale, soft_cap, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(
        head_dim, q, k_pool, v_pool, block_tables, pos, out, batch,
        n_tokens, kv_heads, groups, page_size, n_blocks, stages, scale,
        soft_cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
