// GQA paged-attention decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` / `paged_attention`
// in src/repro/kernels/paged_attention.py: for every decode slot b and KV
// head h, the G query rows of that head attend to the slot's KV history,
// which lives in physical pages (P, page, KV, hd) reached through the
// slot's block-table row.  s = (q . k) * scale, optional tanh soft cap,
// mask k_pos <= pos, online softmax in float32, out = acc / max(l, 1e-30).
//
// Bound on the card: bytes.  One call reads every live KV line once
// ((pos + 1) lines of 2 * hd elements per slot and KV head) plus q and the
// output; the arithmetic is 4 * G * hd FLOPs per line, far under the
// ridge.  At 4 slots x 8 KV heads x 256 context x hd 128 in bf16 that is
// ~4.2 MB, ~1.3 us at 3.35 TB/s.
//
// bf16 queries take csrc/gqa_core.cu (wgmma with the rows as M, split-K
// over chunks of pages merged in chunk order), the core that the verify
// walk and the ring call too; the wrapper picks it by the queries' dtype.
// This source is the float32 path, on the CUDA cores.
//
// Quantized pools (int8 / fp8 e4m3 codes, csrc/kv_load.cuh): the pool's
// storage type S is the kernel's second template parameter; a lane still
// covers VEC elements of the query's dtype, loading VEC codes (4 bytes
// beside a float32 query), and each stream reads its
// line's K and V scales (k_scale / v_scale (P, page, KV) float32) once;
// every element dequantizes as float(code) * scale before the dot
// product, the Pallas kernel's op order (paged_attention.py, the
// `quantized` branch of `_paged_decode_kernel`).  The line bytes shrink
// to hd + 4 per K and per V; 16-byte code loads are later work.
//
// Design for that bound, kept simple for a first kernel:
// * one block per (KV head, slot); it reads its own block-table row and
//   position (no scalar prefetch on a GPU) and walks only the live lines,
//   so dead trash-page entries past pos are never read;
// * a warp holds TPW token streams; each stream is LANES lanes that cover
//   one head vector of hd elements with 16-byte loads, so a line is read
//   by consecutive lanes in one coalesced transaction;
// * the G query rows sit in registers; each stream keeps its own
//   (m, l, acc) online-softmax state in float32 and P.V stays in float32
//   (as in the Pallas kernel, unlike the jnp reference which casts p to
//   the value dtype first);
// * the streams' states merge in shared memory at the end.
// The grid is KV x B blocks (32 on the main path, on 132 SMs), so at small
// batch the kernel is latency- and occupancy-bound, not bandwidth-bound.
//
// C interface (bound with ctypes by repro_torch/kernels/build.py):
//   int paged_attention_decode(q, k_pool, v_pool, k_scale, v_scale,
//                              block_tables, pos, out, batch, kv_heads,
//                              groups, head_dim, page_size, n_blocks,
//                              scale, soft_cap, dtype /*0 f32*/,
//                              kv_dtype /*0 as q, 1 int8, 2 fp8 e4m3*/,
//                              stream)
// (the scale pointers are null unless kv_dtype quantizes) returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head_dim / groups / dtype the kernel is not built for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_load.cuh"

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;

// elements of the query's dtype per lane vector (16 bytes of T)
template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

// T: the query / output dtype, float (bf16 queries take csrc/gqa_core.cu);
// S: the pools' storage type (T, int8_t or __nv_fp8_e4m3)
template <typename T, typename S, int HD, int GMAX>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const S* __restrict__ k_pool,
                    const S* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    int kv_heads, int groups, int page_size, int n_blocks,
                    float scale, float soft_cap) {
  constexpr int VEC = VecWidth<T>::N;
  constexpr int LANES = (HD / VEC < 32) ? HD / VEC : 32;  // lanes per line
  constexpr int NV = HD / (VEC * LANES);                  // vectors per lane
  constexpr int EPL = NV * VEC;                           // elems per lane
  constexpr int TPW = 32 / LANES;                         // streams per warp
  constexpr int STREAMS = kWarps * TPW;
  static_assert(HD % (VEC * LANES) == 0, "head_dim must tile the lanes");

  __shared__ float sm_m[STREAMS][GMAX];
  __shared__ float sm_l[STREAMS][GMAX];
  __shared__ float sm_acc[STREAMS][GMAX][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LANES;       // stream within the warp
  const int sub = lane % LANES;       // lane within the stream
  const int stream = warp * TPW + grp;

  // element offset of this lane's v-th vector within a head vector
  auto elem = [&](int v) { return (v * LANES + sub) * VEC; };

  const T* qb = q + ((size_t)b * kv_heads + h) * groups * HD;
  float qr[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (g < groups) {
        kv_load::widen<VEC>(qb + g * HD + elem(v), &qr[g][v * VEC]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) qr[g][v * VEC + i] = 0.f;
      }
    }
  }

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // lines 0..pos are live (k_pos <= pos); everything past is masked, so
  // it is not read at all
  const int n_lines = min(pos[b] + 1, n_blocks * page_size);
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
    for (int g = 0; g < GMAX; ++g) {
      if (g >= groups) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qr[g][e] * kf[e];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (!live) continue;
      s *= scale;
      if (soft_cap > 0.f) s = tanhf(s / soft_cap) * soft_cap;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vf[e];
      m[g] = m_new;
    }
  }

  // merge the streams' (m, l, acc) states
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (sub == 0) {
      sm_m[stream][g] = m[g];
      sm_l[stream][g] = l[g];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        sm_acc[stream][g][elem(v) + i] = acc[g][v * VEC + i];
  }
  __syncthreads();

  T* ob = out + ((size_t)b * kv_heads + h) * groups * HD;
  for (int idx = threadIdx.x; idx < groups * HD; idx += blockDim.x) {
    const int g = idx / HD;
    const int d = idx % HD;
    float m_all = kNegInf;
    for (int s = 0; s < STREAMS; ++s) m_all = fmaxf(m_all, sm_m[s][g]);
    float l_all = 0.f, o = 0.f;
    for (int s = 0; s < STREAMS; ++s) {
      const float w = expf(sm_m[s][g] - m_all);
      l_all += sm_l[s][g] * w;
      o += sm_acc[s][g][d] * w;
    }
    store_val(ob + idx, o / fmaxf(l_all, 1e-30f));
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
  int batch, kv_heads, groups, page_size, n_blocks;
  float scale, soft_cap;
  cudaStream_t stream;
};

template <typename T, typename S, int HD, int GMAX>
void launch(const Args& a) {
  const dim3 grid(a.kv_heads, a.batch);
  paged_decode_kernel<T, S, HD, GMAX><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.ks, a.vs,
      static_cast<const int32_t*>(a.bt), static_cast<const int32_t*>(a.pos),
      static_cast<T*>(a.out), a.kv_heads, a.groups, a.page_size, a.n_blocks,
      a.scale, a.soft_cap);
}

template <typename T, typename S, int HD>
bool dispatch_groups(const Args& a) {
  const int groups = a.groups;
#define PA_LAUNCH(GM) launch<T, S, HD, GM>(a)
  if (groups <= 1) { PA_LAUNCH(1); return true; }
  if (groups <= 2) { PA_LAUNCH(2); return true; }
  if (groups <= 4) { PA_LAUNCH(4); return true; }
  if (groups <= 8) { PA_LAUNCH(8); return true; }
#undef PA_LAUNCH
  return false;
}

template <typename T, typename S>
bool dispatch_head_dim(int head_dim, const Args& a) {
#define PA_HD(HD)                                                           \
  case HD:                                                                  \
    return dispatch_groups<T, S, HD>(a);
  switch (head_dim) {
    PA_HD(16)
    PA_HD(32)
    PA_HD(64)
    PA_HD(128)
    PA_HD(256)
    default:
      return false;
  }
#undef PA_HD
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

extern "C" int paged_attention_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos, void* out, int batch, int kv_heads, int groups,
    int head_dim, int page_size, int n_blocks, float scale, float soft_cap,
    int dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || page_size <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype != kv_load::kSame && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), block_tables, pos, out,
               batch, kv_heads, groups, page_size, n_blocks, scale, soft_cap,
               static_cast<cudaStream_t>(stream)};
  const bool ok = dtype == 0 && dispatch_store<float>(kv_dtype, head_dim, a);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
