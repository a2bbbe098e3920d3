"""Paged-attention decode: the hand-written CUDA kernels' wrappers, their
plain PyTorch versions, and the pricing helpers the scheduler imports.

One query token per decode slot attends to that slot's whole cache
history, which lives in physical pages shared across slots
(serve/kv_cache.py).  block_tables (B, n_blocks) int32 map logical block
-> physical page; pos (B,) int32 is the last written position.  Dead
table entries point at trash page 0 and the ``k_pos <= pos`` mask
removes them exactly.

* GQA: q (B, KV, G, hd); k/v pools (P, page, KV, hd).
  :func:`paged_attention_reference` gathers the pages and attends — the
  JAX package's jnp reference, op for op; :func:`paged_attention`
  launches the port of the Pallas ``_paged_decode_kernel``: bf16 queries
  on the tensor-core GQA core ``csrc/gqa_core.cu``, float32 queries on
  ``csrc/paged_attention.cu``.
* MLA, in the absorbed latent space: q_lat (B, H, r), q_rope (B, H, dr);
  latent / rope pools (P, page, r) / (P, page, dr); output o_lat
  (B, H, r).  :func:`mla_paged_attention_reference` is the jnp reference
  op for op; :func:`mla_paged_attention` launches the port of the Pallas
  ``_mla_paged_decode_kernel``: bf16 on the tensor-core MLA core
  ``csrc/mla_core.cu``, float32 on ``csrc/mla_paged_attention.cu``.

Multi-token verification (speculative decoding) scores T = k + 1 query
tokens per slot in one page walk; pos (B,) is then the position of the
FIRST query token and query t sees ``k_pos <= pos + t``:

* GQA: q (B, T, KV, G, hd) -> (B, T, KV, G, hd).
  :func:`paged_attention_verify_reference` is the jnp reference op for
  op; :func:`paged_attention_verify` launches the port of
  ``_paged_verify_kernel`` (bf16 on ``csrc/gqa_core.cu``, float32 on
  ``csrc/paged_attention_verify.cu``).
* MLA: q_lat (B, T, H, r), q_rope (B, T, H, dr) -> o_lat (B, T, H, r).
  :func:`mla_paged_attention_verify_reference` /
  :func:`mla_paged_attention_verify` (bf16 on ``csrc/mla_core.cu``,
  float32 on ``csrc/mla_paged_attention_verify.cu``, the port of
  ``_mla_paged_verify_kernel``).

The JAX package's ``pipeline="double"`` schedule (a two-slab DMA walk,
bit-identical to ``"off"``) becomes one ring walk per family, decode and
verify alike, whose page slabs stream through shared memory with
``cp.async``: :func:`paged_attention_ring` (the port of
``_gqa_paged_double``: bf16 on the GQA core with tiles in flight,
float32 on ``csrc/paged_attention_ring.cu``) and
:func:`mla_paged_attention_ring` (of ``_mla_paged_double``: bf16 on the
MLA core, float32 on ``csrc/mla_paged_attention_ring.cu``).  Their
outputs equal the ``"off"`` kernels' bit for bit.

Quantized KV pools (``kernels/quantize.py``): the four plain versions
and the four single-walk kernels also take int8 / float8_e4m3fn pools with
float32 scale pools — GQA ``k_scale`` / ``v_scale`` (P, page, KV), MLA
``c_scale`` / ``r_scale`` (P, page) — and dequantize every line as
``code.float() * scale`` before the scores, the op order of the Pallas
kernels' scale branches.  With scales the scores, p and P.V are float32
in the plain versions too (the dequantized values are), so only the
summation order and the output rounding separate them from the kernels.
The two ring kernels take them too: a stage carries a page's code slabs
and their (page,) scale slabs, and the rings equal the quantized off
kernels bit for bit.  The two tensor-core cores take the codes as bf16
(exact) and fold the line scales into the scores and into P
(:func:`gqa_split_model`, :func:`mla_split_model`).

The wrappers take CUDA tensors only; ``kernels/ops.py`` routes CPU
tensors to the plain versions.  The kernels keep the scores and ``p``
in float32, as the Pallas kernels do (the cores' bf16 path takes p into
the tensor cores as bf16 hi + lo), while the references round the scores
to the input dtype and cast the probabilities to the value dtype before
the PV product; in bf16 the two therefore differ by bf16 rounding.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e30

# head dims the GQA kernels (decode and verify, both cores) are
# instantiated for, and the most query heads per KV head the float32
# DECODE kernel holds (its rows live in registers; csrc/paged_attention.cu
# dispatches on the same sets).  The float32 verify kernel tiles its T * G
# rows 8 at a time and the bf16 core 64 at a time: both take any count.
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
KERNEL_MAX_GROUPS = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# storage of the K/V (latent) pools, the kernels' second template
# parameter (csrc/kv_load.cuh ``Store``): the query's dtype, or int8 /
# fp8 e4m3 codes with float32 scale pools
_STORE_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}


def _pair(a, b, names: str) -> bool:
    """True when both scale pools are given, False when neither; raises
    on one alone."""
    if (a is None) != (b is None):
        raise ValueError(f"{names}: give both scale pools or neither")
    return a is not None


def _gather_kv(pool, scale_pool, bt, B, S, KV, hd):
    """Gather pages to (B, S, KV, hd), dequantizing (float32) when a scale
    pool (P, page, KV) is given."""
    g = pool[bt].reshape(B, S, KV, hd)
    if scale_pool is None:
        return g
    return g.float() * scale_pool[bt].reshape(B, S, KV)[..., None]


def _gather_latent(pool, scale_pool, bt, B, S):
    """Gather latent pages to (B, S, d), dequantizing when quantized."""
    g = pool[bt].reshape(B, S, -1)
    if scale_pool is None:
        return g
    return g.float() * scale_pool[bt].reshape(B, S)[..., None]


def paged_attention_reference(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float, soft_cap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GQA paged decode, gather-and-attend.  Returns (B, KV, G, hd).
    ``k_scale`` / ``v_scale`` (P, page, KV) float32 dequantize a quantized
    pool before attending (the query is then upcast to float32: torch's
    einsum does not promote, jnp's does)."""
    quantized = _pair(k_scale, v_scale, "paged_attention_reference")
    B = q.shape[0]
    KV, hd = k_pool.shape[2], k_pool.shape[3]
    page_size = k_pool.shape[1]
    S = block_tables.shape[1] * page_size
    bt = block_tables.long()
    k = _gather_kv(k_pool, k_scale, bt, B, S, KV, hd)
    v = _gather_kv(v_pool, v_scale, bt, B, S, KV, hd)
    qq = q.float() if quantized else q
    s = torch.einsum("bkgh,bskh->bkgs", qq, k).float() * scale
    if soft_cap > 0:
        s = torch.tanh(s / soft_cap) * soft_cap
    k_pos = torch.arange(S, device=q.device)
    m = pos.long()[:, None] >= k_pos[None, :]                   # (B, S)
    s = torch.where(m[:, None, None, :], s, NEG_INF)
    p_attn = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgs,bskh->bkgh", p_attn, v).to(q.dtype)


def mla_paged_attention_reference(
    q_lat: torch.Tensor, q_rope: torch.Tensor, c_pool: torch.Tensor,
    r_pool: torch.Tensor, block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float,
    c_scale: Optional[torch.Tensor] = None,
    r_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MLA paged decode in the latent space, gather-and-attend.  Returns
    o_lat (B, H, r); the caller folds ``wv_b`` / ``wo`` back out.
    ``c_scale`` / ``r_scale`` (P, page) float32 dequantize a quantized
    latent pool (the queries are then upcast to float32)."""
    quantized = _pair(c_scale, r_scale, "mla_paged_attention_reference")
    B = q_lat.shape[0]
    S = block_tables.shape[1] * c_pool.shape[1]
    bt = block_tables.long()
    c_kv = _gather_latent(c_pool, c_scale, bt, B, S)
    k_rope = _gather_latent(r_pool, r_scale, bt, B, S)
    ql, qr = (q_lat.float(), q_rope.float()) if quantized else (q_lat, q_rope)
    s = (torch.einsum("bhr,bsr->bhs", ql, c_kv)
         + torch.einsum("bhk,bsk->bhs", qr, k_rope))
    s = s.float() * scale
    valid = (torch.arange(S, device=q_lat.device)[None, :]
             <= pos.long()[:, None])
    s = torch.where(valid[:, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(c_kv.dtype)
    return torch.einsum("bhs,bsr->bhr", w, c_kv).to(q_lat.dtype)


def mla_paged_attention_verify_reference(
    q_lat: torch.Tensor, q_rope: torch.Tensor, c_pool: torch.Tensor,
    r_pool: torch.Tensor, block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float,
    c_scale: Optional[torch.Tensor] = None,
    r_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MLA multi-token paged verification in the latent space.  q_lat
    (B, T, H, r), q_rope (B, T, H, dr): T query tokens per slot at
    positions ``pos + t``.  Returns o_lat (B, T, H, r).  Scales as in
    :func:`mla_paged_attention_reference`."""
    quantized = _pair(c_scale, r_scale,
                      "mla_paged_attention_verify_reference")
    B, T = q_lat.shape[0], q_lat.shape[1]
    S = block_tables.shape[1] * c_pool.shape[1]
    bt = block_tables.long()
    c_kv = _gather_latent(c_pool, c_scale, bt, B, S)
    k_rope = _gather_latent(r_pool, r_scale, bt, B, S)
    ql, qr = (q_lat.float(), q_rope.float()) if quantized else (q_lat, q_rope)
    s = (torch.einsum("bthr,bsr->bhts", ql, c_kv)
         + torch.einsum("bthk,bsk->bhts", qr, k_rope))
    s = s.float() * scale
    q_pos = pos.long()[:, None] + torch.arange(T, device=q_lat.device)
    valid = (q_pos[:, :, None]
             >= torch.arange(S, device=q_lat.device)[None, None, :])
    s = torch.where(valid[:, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(c_kv.dtype)
    return torch.einsum("bhts,bsr->bthr", w, c_kv).to(q_lat.dtype)


def paged_attention_verify_reference(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float, soft_cap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GQA multi-token paged verification, gather-and-attend.  q (B, T, KV,
    G, hd): T query tokens per slot at positions ``pos + t`` (pos is the
    FIRST token's).  Returns (B, T, KV, G, hd).  Scales as in
    :func:`paged_attention_reference`."""
    quantized = _pair(k_scale, v_scale, "paged_attention_verify_reference")
    B, T = q.shape[0], q.shape[1]
    KV, hd = k_pool.shape[2], k_pool.shape[3]
    S = block_tables.shape[1] * k_pool.shape[1]
    bt = block_tables.long()
    k = _gather_kv(k_pool, k_scale, bt, B, S, KV, hd)
    v = _gather_kv(v_pool, v_scale, bt, B, S, KV, hd)
    q_pos = pos.long()[:, None] + torch.arange(T, device=q.device)
    k_pos = torch.arange(S, device=q.device)
    qq = q.float() if quantized else q
    s = torch.einsum("btkgh,bskh->bkgts", qq, k).float() * scale
    if soft_cap > 0:
        s = torch.tanh(s / soft_cap) * soft_cap
    m = q_pos[:, :, None] >= k_pos[None, None, :]               # (B, T, S)
    s = torch.where(m[:, None, None], s, NEG_INF)
    p_attn = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgts,bskh->btkgh", p_attn, v).to(q.dtype)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device, align: int = 16) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _check_pools(q_dtype, pools, scales, scale_shape, device) -> int:
    """Check a kernel's K/V (latent) pools ``[(name, tensor, shape)]`` and
    its scale pools ``[(name, tensor_or_None)]``; returns the storage code
    (``_STORE_CODES``; 0 = the query's dtype).  A pool in the query's
    dtype takes no scales; an int8 / float8_e4m3fn pool needs both,
    float32, contiguous, of ``scale_shape``."""
    store = pools[0][1].dtype
    for name, t, shape in pools:
        _check(name, t, store, shape, device)
    given = _pair(scales[0][1], scales[1][1], "scale pools")
    if store == q_dtype:
        if given:
            raise ValueError(f"scale pools given with an unquantized "
                             f"{store} pool")
        return 0
    if store not in _STORE_CODES:
        raise ValueError(f"pool dtype {store}: not the query's {q_dtype}, "
                         f"nor a quantized {list(_STORE_CODES)}")
    if not given:
        raise ValueError(f"a quantized {store} pool needs its float32 "
                         "scale pools")
    for name, t in scales:
        _check(name, t, torch.float32, scale_shape, device, align=4)
    return _STORE_CODES[store]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _gqa_slab_shapes(q, k_pool, v_pool, block_tables, pos, k_scale=None,
                     v_scale=None):
    """The checks of a GQA query slab q (B, T, KV, G, hd), its pools and
    scale pools, shared by the verify and ring kernels; returns (B, T, KV,
    G, hd, page_size, n_blocks, storage code)."""
    B, T, KV, G, hd = q.shape
    P, page_size = k_pool.shape[0], k_pool.shape[1]
    n_blocks = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {KERNEL_HEAD_DIMS}")
    if T < 1 or G < 1:
        raise ValueError(f"empty query slab: T={T}, G={G}")
    dev = q.device
    _check("q", q, q.dtype, (B, T, KV, G, hd), dev)
    store = _check_pools(
        q.dtype, [("k_pool", k_pool, (P, page_size, KV, hd)),
                  ("v_pool", v_pool, (P, page_size, KV, hd))],
        [("k_scale", k_scale), ("v_scale", v_scale)], (P, page_size, KV),
        dev)
    _check("block_tables", block_tables, torch.int32, (B, n_blocks), dev)
    _check("pos", pos, torch.int32, (B,), dev)
    return B, T, KV, G, hd, page_size, n_blocks, store


def _mla_slab_shapes(q_lat, q_rope, c_pool, r_pool, block_tables, pos,
                     c_scale=None, r_scale=None):
    """The checks of MLA query slabs q_lat (B, T, H, r) / q_rope
    (B, T, H, dr), their pools and scale pools, shared by the verify and
    ring kernels; returns (B, T, H, r, dr, page_size, n_blocks, storage
    code)."""
    B, T, H, r = q_lat.shape
    dr = q_rope.shape[-1]
    P, page_size = c_pool.shape[0], c_pool.shape[1]
    n_blocks = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if q_lat.dtype not in _DTYPE_CODES:
        raise ValueError(f"q_lat dtype {q_lat.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    if r not in MLA_LATENT_DIMS:
        raise ValueError(f"latent rank {r} not in {MLA_LATENT_DIMS}")
    if dr not in MLA_ROPE_DIMS:
        raise ValueError(f"rope dim {dr} not in {MLA_ROPE_DIMS}")
    if page_size not in MLA_PAGE_SIZES:
        raise ValueError(f"page size {page_size} not in {MLA_PAGE_SIZES}")
    if T < 1:
        raise ValueError(f"empty query slab: T={T}")
    dev = q_lat.device
    _check("q_lat", q_lat, q_lat.dtype, (B, T, H, r), dev)
    _check("q_rope", q_rope, q_lat.dtype, (B, T, H, dr), dev)
    store = _check_pools(
        q_lat.dtype, [("c_pool", c_pool, (P, page_size, r)),
                      ("r_pool", r_pool, (P, page_size, dr))],
        [("c_scale", c_scale), ("r_scale", r_scale)], (P, page_size), dev)
    _check("block_tables", block_tables, torch.int32, (B, n_blocks), dev)
    _check("pos", pos, torch.int32, (B,), dev)
    return B, T, H, r, dr, page_size, n_blocks, store


# bf16 queries of all three GQA wrappers take the tensor-core core
# (csrc/gqa_core.cu): blocks of GQA_ROW_TILE of a (slot, KV head)'s T * G
# rows over chunks of GQA_CHUNK_PAGES pages walked GQA_TILE_LINES lines at
# a time; a row group's chunks merged in chunk order by its last block, so
# a call is one kernel launch
GQA_ROW_TILE = 64
GQA_CHUNK_PAGES = 1
GQA_TILE_LINES = 16


def gqa_workspace_bytes(batch: int, n_tokens: int, kv_heads: int,
                        groups: int, n_blocks: int, head_dim: int) -> int:
    """Bytes of the GQA core's workspace (csrc/gqa_core.cu): per (slot, KV
    head, row, chunk) hd float32 sums and the running max and sum, for the
    most chunks a table of ``n_blocks`` pages holds."""
    chunks = -(-int(n_blocks) // GQA_CHUNK_PAGES)
    return (int(batch) * int(kv_heads) * int(n_tokens) * int(groups)
            * chunks * (int(head_dim) + 2) * 4)


def gqa_row_groups(batch: int, n_tokens: int, kv_heads: int,
                   groups: int) -> int:
    """Row groups of a GQA core call, one counter each: (slot, KV head,
    tile of GQA_ROW_TILE of the T * G rows)."""
    tiles = -(-int(n_tokens) * int(groups) // GQA_ROW_TILE)
    return int(batch) * int(kv_heads) * tiles


# the core's arrival counters, one int32 per row group: zeroed once when
# allocated, set back to 0 by every launch's last block of each row group.
# Eager calls take one buffer per (device, stream), replaced by a larger
# one when a call needs more.  A captured CUDA graph keeps the pointer it
# was captured with, so a captured step holds a buffer of its own
# (:func:`hold_gqa_counters`), sized before capture and never replaced
_gqa_counters: dict = {}
_held_counters: list = []


def gqa_counters(n: int, device: torch.device) -> torch.Tensor:
    """A zeroed counter buffer for ``n`` row groups (:func:`gqa_row_groups`)
    on ``device``, for :func:`hold_gqa_counters`."""
    return torch.zeros(max(int(n), 1), dtype=torch.int32, device=device)


@contextlib.contextmanager
def hold_gqa_counters(buf: torch.Tensor):
    """GQA core launches inside this scope count on ``buf`` (from
    :func:`gqa_counters`) instead of the per-stream buffers; a launch that
    needs more row groups than ``buf`` holds raises rather than regrow it
    under a graph that captured its pointer."""
    _held_counters.append(buf)
    try:
        yield buf
    finally:
        _held_counters.pop()


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    if _held_counters:
        buf = _held_counters[-1]
        if buf.device != device or buf.numel() < n:
            raise ValueError(
                f"held GQA counters ({buf.numel()} on {buf.device}) cannot "
                f"take a call of {n} row groups on {device}; size them for "
                "the largest captured call")
        return buf
    key = (device.index, stream)
    buf = _gqa_counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _gqa_counters[key] = buf
    return buf


def gqa_split_plan(pos, n_tokens: int, page_size: int, n_blocks: int,
                   groups: int, kv_heads: int) -> dict:
    """What a bf16 GQA call launches, without launching: the lines of a
    chunk, the grid, the blocks of it that have lines to walk (the rest
    return at once) and the row groups whose blocks merge (more than one
    chunk; the others write their output directly), for positions ``pos``
    (a sequence or tensor of the slots' first query positions) and T =
    ``n_tokens``."""
    chunk = GQA_CHUNK_PAGES * int(page_size)
    cap = int(n_blocks) * int(page_size)
    tiles = -(-int(n_tokens) * int(groups) // GQA_ROW_TILE)
    pos = [int(p) for p in (pos.tolist() if hasattr(pos, "tolist")
                            else pos)]
    chunks = [-(-min(p + int(n_tokens), cap) // chunk) for p in pos]
    max_chunks = -(-int(n_blocks) // GQA_CHUNK_PAGES)
    per_slot = int(kv_heads) * tiles
    return dict(chunk_lines=chunk, grid=max_chunks * per_slot * len(pos),
                blocks=sum(chunks) * per_slot,
                merges=sum(c > 1 for c in chunks) * per_slot)


def gqa_split_model(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float, soft_cap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain model of the tensor-core GQA core's arithmetic order
    (``csrc/gqa_core.cu``), for decode (q (B, KV, G, hd)) or verify (q
    (B, T, KV, G, hd)), the contracts of :func:`paged_attention_reference`
    / :func:`paged_attention_verify_reference`.  Per (slot, KV head): the
    slot's visible lines, min(pos + T, table lines), in chunks of
    ``GQA_CHUNK_PAGES`` pages, each walked in tiles of 16 lines with an
    online softmax (float32 m, l, acc) over the T * G rows, row t G + g
    masked past its line pos + t (p = 0 there, so a row that sees none of
    a chunk keeps (-1e30, 0, 0)); the scores ``(ks S) * scale`` with the
    codes' dot products S taken before the K line scales (scales 1 for
    bf16 pools), then the soft cap; P times each line's V scale, split into
    bf16 hi + lo, both multiplied by the codes; one chunk: out = acc /
    max(l, 1e-30), else the chunks' (m, l, acc) merged in chunk order and
    out = O / max(L, 1e-30), in q's dtype.  Float32 sums in torch's
    order, so it agrees with the kernel up to summation order and the
    output's one rounding."""
    quantized = _pair(k_scale, v_scale, "gqa_split_model")
    decode = q.dim() == 4
    q5 = (q[:, None] if decode else q).float()
    B, T, KV, G, hd = q5.shape
    page, nb = k_pool.shape[1], block_tables.shape[1]
    codes_k = k_pool.float().reshape(-1, KV, hd)
    codes_v = v_pool.float().reshape(-1, KV, hd)
    if quantized:
        sc_k, sc_v = k_scale.reshape(-1, KV), v_scale.reshape(-1, KV)
    chunk = GQA_CHUNK_PAGES * page
    dev = q5.device
    out = torch.empty((B, T, KV, G, hd), dtype=torch.float32, device=dev)
    for b in range(B):
        n = min(int(pos[b]) + T, nb * page)
        line = torch.arange(n, device=dev)
        rows = block_tables[b].long()[line // page] * page + line % page
        lim = (int(pos[b]) + torch.arange(T, device=dev)).repeat_interleave(G)
        for h in range(KV):
            qq = q5[b, :, h].reshape(T * G, hd)
            kk, vv = codes_k[rows, h], codes_v[rows, h]
            parts = []
            for c0 in range(0, n, chunk):
                m = torch.full((T * G,), NEG_INF, device=dev)
                l = torch.zeros((T * G,), device=dev)
                acc = torch.zeros((T * G, hd), device=dev)
                for t0 in range(c0, min(c0 + chunk, n), GQA_TILE_LINES):
                    sl = slice(t0, min(t0 + GQA_TILE_LINES, c0 + chunk, n))
                    s = qq @ kk[sl].T
                    if quantized:
                        s = sc_k[rows[sl], h] * s
                    s = s * scale
                    if soft_cap > 0:
                        s = torch.tanh(s / soft_cap) * soft_cap
                    ok = line[sl][None, :] <= lim[:, None]
                    s = torch.where(ok, s, NEG_INF)
                    mx = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - mx)
                    p = torch.where(ok, torch.exp(s - mx[:, None]), 0.0)
                    l = l * alpha + p.sum(-1)
                    m = mx
                    if quantized:
                        p = p * sc_v[rows[sl], h]
                    hi = p.bfloat16().float()
                    lo = (p - hi).bfloat16().float()
                    acc = acc * alpha[:, None] + hi @ vv[sl] + lo @ vv[sl]
                parts.append((m, l, acc))
            if len(parts) == 1:
                o, den = parts[0][2], parts[0][1]
            else:
                top = torch.stack([m for m, _, _ in parts]).max(0).values
                den = torch.zeros((T * G,), device=dev)
                o = torch.zeros((T * G, hd), device=dev)
                for m, l, acc in parts:
                    w = torch.exp(m - top)
                    den = den + l * w
                    o = o + acc * w[:, None]
            out[b, :, h] = (o / den.clamp_min(1e-30)[:, None]).reshape(
                T, G, hd)
    out = out.to(q.dtype)
    return out[:, 0] if decode else out


def gqa_core_run(q5: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor], block_tables: torch.Tensor,
                 pos: torch.Tensor, out: torch.Tensor, *, stages: int,
                 scale: float, soft_cap: float, store: int) -> int:
    """Launch the tensor-core GQA core (``csrc/gqa_core.cu``) on bf16
    queries q5 (B, T, KV, G, hd) into ``out``, with ``stages`` tiles in
    flight (1: each tile staged synchronously), over a workspace it
    allocates and the stream's counters (a captured step's own, under
    :func:`hold_gqa_counters`); returns the CUDA error code.  The shapes
    are the caller's, checked."""
    lib = build.library("gqa_core", GQA_CORE_C_SIGNATURES)
    B, T, KV, G, hd = q5.shape
    n_blocks = block_tables.shape[1]
    dev = q5.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = torch.empty(gqa_workspace_bytes(B, T, KV, G, n_blocks, hd),
                       dtype=torch.uint8, device=dev)
    counters = _counters(dev, stream, gqa_row_groups(B, T, KV, G))
    return lib.gqa_core_attention(
        q5.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), pos.data_ptr(),
        out.data_ptr(), work.data_ptr(), counters.data_ptr(), B, T, KV, G,
        hd, k_pool.shape[1], n_blocks, int(stages), float(scale),
        float(soft_cap), store, stream)


# the C interface of csrc/gqa_core.cu
GQA_CORE_C_SIGNATURES = {
    "gqa_core_attention": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
}


def paged_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float, soft_cap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA decode kernel on the current stream (no sync).

    Same contract as :func:`paged_attention_reference`.  Takes CUDA
    tensors only: a bf16 or f32 q, pools in q's dtype or int8 /
    float8_e4m3fn with both float32 scale pools (P, page, KV), head_dim in
    ``KERNEL_HEAD_DIMS``, int32 block tables and positions.  bf16 queries
    run on the tensor cores (``csrc/gqa_core.cu`` with T 1: split-K over
    chunks of pages, merged in the launch, :func:`gqa_split_plan`; the
    arithmetic order of :func:`gqa_split_model`) and take any count of
    query heads per KV head; float32 queries run on the CUDA cores
    (``csrc/paged_attention.cu``), at most ``KERNEL_MAX_GROUPS`` query
    heads per KV head.  ``launches`` counts the kernel launches this
    wrapper made, one a call."""
    if not q.is_cuda:
        raise ValueError(
            "paged_attention launches a CUDA kernel and takes CUDA tensors "
            f"only (q is on {q.device}); kernels.ops dispatches CPU tensors "
            "to paged_attention_reference")
    B, _, KV, G, hd, page_size, n_blocks, store = _gqa_slab_shapes(
        q[:, None], k_pool, v_pool, block_tables, pos, k_scale, v_scale)
    dev = q.device
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        err = gqa_core_run(q[:, None], k_pool, v_pool, k_scale, v_scale,
                        block_tables, pos, out, stages=1, scale=scale,
                        soft_cap=soft_cap, store=store)
    else:
        if not 1 <= G <= KERNEL_MAX_GROUPS:
            raise ValueError(
                f"{G} query heads per KV head; the float32 decode kernel "
                f"takes 1..{KERNEL_MAX_GROUPS} (bf16 queries and the verify "
                "kernel take any count)")
        lib = build.library("paged_attention", C_SIGNATURES)
        err = lib.paged_attention_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, KV, G, hd, page_size,
            n_blocks, float(scale), float(soft_cap), _DTYPE_CODES[q.dtype],
            store, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

# the C interface of csrc/paged_attention.cu, bound by kernels/build.py
C_SIGNATURES = {
    "paged_attention_decode": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
        ctypes.c_int),
}


# latent ranks, rope dims and page sizes the MLA kernel is instantiated
# for, and its heads-per-block tile; csrc/mla_paged_attention.cu
# dispatches on the same sets
MLA_LATENT_DIMS = (32, 64, 128, 256, 512)
MLA_ROPE_DIMS = (8, 16, 32, 64)
MLA_PAGE_SIZES = (8, 16, 32)
MLA_HEADS_PER_BLOCK = 8
# bf16 queries of all three MLA wrappers take the tensor-core core
# (csrc/mla_core.cu): blocks of MLA_HEAD_TILE heads over chunks of
# MLA_CHUNK_PAGES pages, output columns in parts of at most
# MLA_COLUMN_PART, the chunks' float32 partials merged in chunk order by
# a second kernel (MLA_CORE_LAUNCHES kernels a call)
MLA_HEAD_TILE = 64
MLA_CHUNK_PAGES = 2
MLA_COLUMN_PART = 256
MLA_CORE_LAUNCHES = 2


def mla_launches_per_call(dtype: torch.dtype) -> int:
    """Kernel launches of one call of an MLA wrapper with ``dtype``
    queries: the core's split and merge kernels for bf16, the CUDA-core
    kernel alone for float32."""
    return MLA_CORE_LAUNCHES if dtype == torch.bfloat16 else 1


def mla_workspace_bytes(rows: int, n_blocks: int, n_heads: int,
                        latent_dim: int) -> int:
    """Bytes of the tensor-core MLA kernels' workspace for ``rows``
    (slot, token) rows over a table of ``n_blocks`` pages
    (``workspace_bytes`` in ``csrc/mla_core.cu``): each row's most chunks
    x heads x (r
    float32 sums + the running max and sum)."""
    chunks = -(-int(n_blocks) // MLA_CHUNK_PAGES)
    return int(rows) * chunks * int(n_heads) * (int(latent_dim) + 2) * 4


def mla_split_plan(pos, n_tokens: int, page_size: int, n_blocks: int,
                   n_heads: int, latent_dim: int) -> dict:
    """What a bf16 MLA call launches: the lines of a chunk, the split
    kernel's grid and the blocks of it that have lines to walk (the rest
    return at once), for positions ``pos`` (a sequence or tensor of the
    slots' first query positions) and T = ``n_tokens``."""
    chunk = MLA_CHUNK_PAGES * int(page_size)
    parts = max(1, -(-int(latent_dim) // 64) * 64 // MLA_COLUMN_PART)
    tiles = -(-int(n_heads) // MLA_HEAD_TILE)
    cap = int(n_blocks) * int(page_size)
    pos = [int(p) for p in (pos.tolist() if hasattr(pos, "tolist")
                            else pos)]
    active = sum(-(-min(p + t + 1, cap) // chunk)
                 for p in pos for t in range(int(n_tokens)))
    max_chunks = -(-int(n_blocks) // MLA_CHUNK_PAGES)
    return dict(chunk_lines=chunk,
                grid=max_chunks * parts * tiles * len(pos) * int(n_tokens),
                blocks=active * parts * tiles)


def mla_split_model(
    q_lat: torch.Tensor, q_rope: torch.Tensor, c_pool: torch.Tensor,
    r_pool: torch.Tensor, block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float,
    c_scale: Optional[torch.Tensor] = None,
    r_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain model of the tensor-core MLA kernels' arithmetic order
    (``csrc/mla_core.cu``), for decode (q_lat (B, H, r)) or verify (q_lat
    (B, T, H, r)), the contracts of :func:`mla_paged_attention_reference`
    / :func:`mla_paged_attention_verify_reference`.  Per (slot, token):
    the visible lines in chunks of ``MLA_CHUNK_PAGES`` pages, each walked
    in tiles of 16 lines with an online softmax (float32 m, l, acc); the
    scores ``scale (sc_c S_c + sc_r S_r)`` with the codes' dot products
    S_c, S_r taken before the line scales (scales 1 for bf16 pools); P
    times each line's latent scale, split into bf16 hi + lo, both
    multiplied by the codes; the chunks' (m, l, acc) merged in chunk
    order; out = O / max(L, 1e-30) in q's dtype.  Float32 sums in torch's
    order, so it agrees with the kernel up to summation order and the
    output's one rounding."""
    quantized = _pair(c_scale, r_scale, "mla_split_model")
    decode = q_lat.dim() == 3
    ql = (q_lat[:, None] if decode else q_lat).float()
    qr = (q_rope[:, None] if decode else q_rope).float()
    B, T, H, r = ql.shape
    page, nb = c_pool.shape[1], block_tables.shape[1]
    codes_c = c_pool.float().reshape(-1, r)
    codes_r = r_pool.float().reshape(-1, r_pool.shape[-1])
    if quantized:
        sc_c, sc_r = c_scale.reshape(-1), r_scale.reshape(-1)
    chunk = MLA_CHUNK_PAGES * page
    out = torch.empty((B, T, H, r), dtype=torch.float32, device=ql.device)
    for b in range(B):
        for t in range(T):
            n = min(int(pos[b]) + t + 1, nb * page)
            line = torch.arange(n, device=ql.device)
            rows = block_tables[b].long()[line // page] * page + line % page
            cc, rr = codes_c[rows], codes_r[rows]
            parts = []
            for c0 in range(0, n, chunk):
                m = torch.full((H,), NEG_INF, device=ql.device)
                l = torch.zeros((H,), device=ql.device)
                acc = torch.zeros((H, r), device=ql.device)
                for t0 in range(c0, min(c0 + chunk, n), 16):
                    sl = slice(t0, min(t0 + 16, c0 + chunk, n))
                    s_c, s_r = ql[b, t] @ cc[sl].T, qr[b, t] @ rr[sl].T
                    if quantized:
                        s = sc_c[rows[sl]] * s_c + sc_r[rows[sl]] * s_r
                    else:
                        s = s_c + s_r
                    s = s * scale
                    mx = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - mx)
                    p = torch.exp(s - mx[:, None])
                    l = l * alpha + p.sum(-1)
                    m = mx
                    if quantized:
                        p = p * sc_c[rows[sl]]
                    hi = p.bfloat16().float()
                    lo = (p - hi).bfloat16().float()
                    acc = acc * alpha[:, None] + hi @ cc[sl] + lo @ cc[sl]
                parts.append((m, l, acc))
            top = torch.stack([m for m, _, _ in parts]).max(0).values
            den = torch.zeros((H,), device=ql.device)
            o = torch.zeros((H, r), device=ql.device)
            for m, l, acc in parts:
                w = torch.exp(m - top)
                den = den + l * w
                o = o + acc * w[:, None]
            out[b, t] = o / den.clamp_min(1e-30)[:, None]
    out = out.to(q_lat.dtype)
    return out[:, 0] if decode else out


def _mla_core(ql4: torch.Tensor, qr4: torch.Tensor, c_pool: torch.Tensor,
              r_pool: torch.Tensor, c_scale: Optional[torch.Tensor],
              r_scale: Optional[torch.Tensor], block_tables: torch.Tensor,
              pos: torch.Tensor, out: torch.Tensor, *, stages: int,
              scale: float, store: int) -> int:
    """Launch the tensor-core core (``csrc/mla_core.cu``: the split kernel,
    then the merge kernel) on bf16 queries ql4 (B, T, H, r) / qr4 (B, T,
    H, dr) into ``out``, with ``stages`` tiles in flight (1: each tile
    staged synchronously) over a workspace it allocates; returns the CUDA
    error code.  The shapes are the caller's, checked."""
    B, T, H, r = ql4.shape
    n_blocks = block_tables.shape[1]
    work = torch.empty(mla_workspace_bytes(B * T, n_blocks, H, r),
                       dtype=torch.uint8, device=ql4.device)
    lib = build.library("mla_core", MLA_CORE_C_SIGNATURES)
    return lib.mla_core_attention(
        ql4.data_ptr(), qr4.data_ptr(), c_pool.data_ptr(), r_pool.data_ptr(),
        _ptr(c_scale), _ptr(r_scale), block_tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), work.data_ptr(), B, T, H, r,
        qr4.shape[-1], c_pool.shape[1], n_blocks, int(stages), float(scale),
        store, torch.cuda.current_stream(ql4.device).cuda_stream)


# the C interface of csrc/mla_core.cu
MLA_CORE_C_SIGNATURES = {
    "mla_core_attention": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
}


def mla_paged_attention(
    q_lat: torch.Tensor, q_rope: torch.Tensor, c_pool: torch.Tensor,
    r_pool: torch.Tensor, block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float,
    c_scale: Optional[torch.Tensor] = None,
    r_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA MLA decode kernel on the current stream (no sync).

    Same contract as :func:`mla_paged_attention_reference`.  Takes CUDA
    tensors only: bf16 or f32 queries, pools in their dtype or int8 /
    float8_e4m3fn with both float32 scale pools (P, page), latent rank in
    ``MLA_LATENT_DIMS``, rope dim in ``MLA_ROPE_DIMS``, page size in
    ``MLA_PAGE_SIZES``, any head count (the last head block is masked),
    int32 block tables and positions.  bf16 queries run on the tensor
    cores (``csrc/mla_core.cu``: a split kernel over chunks of pages and
    a merge kernel, :func:`mla_split_plan`; the arithmetic order of
    :func:`mla_split_model`), float32 queries on the CUDA cores
    (``csrc/mla_paged_attention.cu``).  ``launches`` counts the kernel
    launches this wrapper made (:func:`mla_launches_per_call` a call)."""
    if not q_lat.is_cuda:
        raise ValueError(
            "mla_paged_attention launches a CUDA kernel and takes CUDA "
            f"tensors only (q_lat is on {q_lat.device}); kernels.ops "
            "dispatches CPU tensors to mla_paged_attention_reference")
    B, H, r = q_lat.shape
    dr = q_rope.shape[-1]
    P, page_size = c_pool.shape[0], c_pool.shape[1]
    n_blocks = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if q_lat.dtype not in _DTYPE_CODES:
        raise ValueError(f"q_lat dtype {q_lat.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    if r not in MLA_LATENT_DIMS:
        raise ValueError(f"latent rank {r} not in {MLA_LATENT_DIMS}")
    if dr not in MLA_ROPE_DIMS:
        raise ValueError(f"rope dim {dr} not in {MLA_ROPE_DIMS}")
    if page_size not in MLA_PAGE_SIZES:
        raise ValueError(f"page size {page_size} not in {MLA_PAGE_SIZES}")
    dev = q_lat.device
    _check("q_lat", q_lat, q_lat.dtype, (B, H, r), dev)
    _check("q_rope", q_rope, q_lat.dtype, (B, H, dr), dev)
    store = _check_pools(
        q_lat.dtype, [("c_pool", c_pool, (P, page_size, r)),
                      ("r_pool", r_pool, (P, page_size, dr))],
        [("c_scale", c_scale), ("r_scale", r_scale)], (P, page_size), dev)
    _check("block_tables", block_tables, torch.int32, (B, n_blocks), dev)
    _check("pos", pos, torch.int32, (B,), dev)
    out = torch.empty_like(q_lat)
    if q_lat.dtype == torch.bfloat16:
        err = _mla_core(q_lat[:, None], q_rope[:, None], c_pool, r_pool,
                        c_scale, r_scale, block_tables, pos, out, stages=1,
                        scale=scale, store=store)
    else:
        lib = build.library("mla_paged_attention", MLA_C_SIGNATURES)
        err = lib.mla_paged_attention_decode(
            q_lat.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
            r_pool.data_ptr(), _ptr(c_scale), _ptr(r_scale),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H,
            r, dr, page_size, n_blocks, float(scale),
            _DTYPE_CODES[q_lat.dtype], store,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    mla_paged_attention.launches += mla_launches_per_call(q_lat.dtype)
    return out


mla_paged_attention.launches = 0

# the C interface of csrc/mla_paged_attention.cu
MLA_C_SIGNATURES = {
    "mla_paged_attention_decode": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
}


def paged_attention_verify(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float, soft_cap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA GQA verify kernel on the current stream (no sync).

    Same contract as :func:`paged_attention_verify_reference`.  Takes CUDA
    tensors only: a bf16 or f32 q, pools in q's dtype or int8 /
    float8_e4m3fn with both float32 scale pools (P, page, KV), head_dim in
    ``KERNEL_HEAD_DIMS``, any number T of query tokens and G of query
    heads per KV head, int32 block tables and positions.  bf16 queries run
    on the tensor-core core as :func:`paged_attention` does (the T * G rows
    of a KV head 64 at a time, chunks fixed by the slot's visible lines),
    so T = 1 equals the decode call bit for bit; float32 queries on
    ``csrc/paged_attention_verify.cu`` (the rows 8 at a time).
    ``launches`` counts the kernel launches this wrapper made, one a
    call."""
    if not q.is_cuda:
        raise ValueError(
            "paged_attention_verify launches a CUDA kernel and takes CUDA "
            f"tensors only (q is on {q.device}); kernels.ops dispatches CPU "
            "tensors to paged_attention_verify_reference")
    B, T, KV, G, hd, page_size, n_blocks, store = _gqa_slab_shapes(
        q, k_pool, v_pool, block_tables, pos, k_scale, v_scale)
    dev = q.device
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        err = gqa_core_run(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                        pos, out, stages=1, scale=scale, soft_cap=soft_cap,
                        store=store)
    else:
        lib = build.library("paged_attention_verify", VERIFY_C_SIGNATURES)
        err = lib.paged_attention_verify(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, T, KV, G, hd, page_size,
            n_blocks, float(scale), float(soft_cap), _DTYPE_CODES[q.dtype],
            store, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_verify kernel launch failed: "
                           f"CUDA error {err}")
    paged_attention_verify.launches += 1
    return out


paged_attention_verify.launches = 0

# the C interface of csrc/paged_attention_verify.cu
VERIFY_C_SIGNATURES = {
    "paged_attention_verify": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
        ctypes.c_int),
}


def mla_paged_attention_verify(
    q_lat: torch.Tensor, q_rope: torch.Tensor, c_pool: torch.Tensor,
    r_pool: torch.Tensor, block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float,
    c_scale: Optional[torch.Tensor] = None,
    r_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA MLA verify kernel on the current stream (no sync).

    Same contract as :func:`mla_paged_attention_verify_reference`, and the
    same sets as :func:`mla_paged_attention`: bf16 or f32 queries, pools in
    their dtype or int8 / float8_e4m3fn with float32 scale pools, latent
    rank in ``MLA_LATENT_DIMS``, rope dim in ``MLA_ROPE_DIMS``, page size
    in ``MLA_PAGE_SIZES``, any head count and any T >= 1, int32 block
    tables and positions; bf16 on the tensor-core core as there, one
    (slot, token) row a block, so T = 1 equals the decode call bit for
    bit; float32 on ``csrc/mla_paged_attention_verify.cu``.  ``launches``
    counts the kernel launches this wrapper made
    (:func:`mla_launches_per_call` a call)."""
    if not q_lat.is_cuda:
        raise ValueError(
            "mla_paged_attention_verify launches a CUDA kernel and takes "
            f"CUDA tensors only (q_lat is on {q_lat.device}); kernels.ops "
            "dispatches CPU tensors to mla_paged_attention_verify_reference")
    B, T, H, r, dr, page_size, n_blocks, store = _mla_slab_shapes(
        q_lat, q_rope, c_pool, r_pool, block_tables, pos, c_scale, r_scale)
    dev = q_lat.device
    out = torch.empty_like(q_lat)
    if q_lat.dtype == torch.bfloat16:
        err = _mla_core(q_lat, q_rope, c_pool, r_pool, c_scale, r_scale,
                        block_tables, pos, out, stages=1, scale=scale,
                        store=store)
    else:
        lib = build.library("mla_paged_attention_verify",
                            MLA_VERIFY_C_SIGNATURES)
        err = lib.mla_paged_attention_verify(
            q_lat.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
            r_pool.data_ptr(), _ptr(c_scale), _ptr(r_scale),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, T,
            H, r, dr, page_size, n_blocks, float(scale),
            _DTYPE_CODES[q_lat.dtype], store,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_paged_attention_verify kernel launch "
                           f"failed: CUDA error {err}")
    mla_paged_attention_verify.launches += mla_launches_per_call(q_lat.dtype)
    return out


mla_paged_attention_verify.launches = 0

# the C interface of csrc/mla_paged_attention_verify.cu
MLA_VERIFY_C_SIGNATURES = {
    "mla_paged_attention_verify": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
}


# --------------------------------------------------------------------------
# Ring kernels (pipeline="double"): the same functions, pages streamed
# through a ring of shared-memory slabs with cp.async
# --------------------------------------------------------------------------

# the ring holds 2..RING_MAX_STAGES slabs, as many as fit beside the
# block-table copy in RING_SMEM_BYTES of dynamic shared memory (227 KB a
# block on Hopper, less 2 KB for static shared memory)
RING_MAX_STAGES = 4
RING_SMEM_BYTES = 225 * 1024
# lines of one MLA ring stage (the off kernels' tile, csrc kTileLines; the
# tensor-core core's too)
MLA_RING_TILE_LINES = 16


def gqa_ring_stage_bytes(page_size: int, head_dim: int, kv_isize: int,
                         quantized: bool = False) -> int:
    """Bytes of one stage of the GQA ring (``stage_bytes`` in
    ``csrc/paged_attention_ring.cu``): a page's K and V slabs at the
    pools' element size ``kv_isize`` and, for a quantized pool, K's and
    V's (page,) float32 scales of one KV head; rounded up to 16."""
    n = 2 * int(page_size) * int(head_dim) * int(kv_isize)
    if quantized:
        n += 2 * int(page_size) * 4
    return -(-n // 16) * 16


def mla_ring_stage_bytes(latent_dim: int, rope_dim: int, kv_isize: int,
                         quantized: bool = False) -> int:
    """Bytes of one stage of the MLA ring (``stage_bytes`` in
    ``csrc/mla_paged_attention_ring.cu``): ``MLA_RING_TILE_LINES`` latent
    and rope lines at the pools' element size and, for a quantized pool,
    each line's latent and rope float32 scale."""
    line = (int(latent_dim) + int(rope_dim)) * int(kv_isize)
    return MLA_RING_TILE_LINES * (line + (8 if quantized else 0))


def mla_core_stages(latent_dim: int, rope_dim: int, quantized: bool,
                    page_size: int) -> int:
    """Tiles the ring keeps in flight in the tensor-core MLA core
    (``Shape::smem_bytes`` in ``csrc/mla_core.cu``): at most
    ``RING_MAX_STAGES`` and a chunk's tiles, as many as fit in
    ``RING_SMEM_BYTES`` beside the 64 heads' queries (and, for a quantized
    pool, the widened tile).  A stage is a bf16 tile of (r / 64 + 1)
    128-byte swizzle atoms of 16 lines, or 16 raw code lines and their
    32 float32 scales."""
    atoms = -(-int(latent_dim) // 64) + 1
    tile = atoms * MLA_RING_TILE_LINES * 128
    if quantized:
        stage = MLA_RING_TILE_LINES * (int(latent_dim) + int(rope_dim) + 8)
    else:
        stage = tile
    fixed = 1024 + atoms * MLA_HEAD_TILE * 128 + (tile if quantized else 0)
    chunk_tiles = -(-MLA_CHUNK_PAGES * int(page_size) // MLA_RING_TILE_LINES)
    return max(1, min(RING_MAX_STAGES, chunk_tiles,
                      (RING_SMEM_BYTES - fixed) // stage))


def gqa_core_stages(head_dim: int, quantized: bool, page_size: int) -> int:
    """Tiles the ring keeps in flight in the tensor-core GQA core
    (``Shape::smem_bytes`` in ``csrc/gqa_core.cu``): at most
    ``RING_MAX_STAGES`` and a chunk's tiles, as many as fit in
    ``RING_SMEM_BYTES`` beside the 64 rows' queries (and, for a quantized
    pool, the widened K and V tiles).  A stage is a K and a V tile of
    max(hd, 64) / 64 128-byte swizzle atoms of 16 lines, or 16 raw K and V
    code lines and their 32 float32 scales."""
    atoms = max(int(head_dim), 64) // 64
    tile = atoms * GQA_TILE_LINES * 128
    if quantized:
        stage = 2 * GQA_TILE_LINES * int(head_dim) + 2 * GQA_TILE_LINES * 4
    else:
        stage = 2 * tile
    fixed = 1024 + atoms * GQA_ROW_TILE * 128 + (2 * tile if quantized else 0)
    chunk_tiles = -(-GQA_CHUNK_PAGES * int(page_size) // GQA_TILE_LINES)
    return max(1, min(RING_MAX_STAGES, chunk_tiles,
                      (RING_SMEM_BYTES - fixed) // stage))


def ring_stages(stage_bytes: int, n_blocks: int) -> int:
    """Slabs in a ring kernel's ring: at most ``RING_MAX_STAGES``, as many
    as fit beside the block-table copy (16-byte padded); raises when not
    even two do."""
    table = -(-4 * int(n_blocks) // 16) * 16
    stages = min(RING_MAX_STAGES, (RING_SMEM_BYTES - table) // stage_bytes)
    if stages < 2:
        raise ValueError(
            f"a ring of two {stage_bytes}-byte slabs and a {table}-byte "
            f"block table does not fit in {RING_SMEM_BYTES} bytes of shared "
            "memory; use a smaller page or pipeline='off'")
    return int(stages)


def paged_attention_ring(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float, soft_cap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA GQA ring walk on the current stream (no sync):
    decode with q (B, KV, G, hd), the contract of
    :func:`paged_attention_reference`, or verification with q (B, T, KV,
    G, hd), that of :func:`paged_attention_verify_reference`.  The output
    equals :func:`paged_attention` / :func:`paged_attention_verify` bit
    for bit, on quantized pools too.  Takes CUDA tensors only: a bf16 or
    f32 q, pools in q's dtype or int8 / float8_e4m3fn with both float32
    scale pools (P, page, KV), head_dim in ``KERNEL_HEAD_DIMS``, any T and
    G.  bf16 runs the off walks' tensor-core core (``csrc/gqa_core.cu``)
    with :func:`gqa_core_stages` tiles in flight; float32 the CUDA-core
    ring ``csrc/paged_attention_ring.cu``, whose stage
    (:func:`gqa_ring_stage_bytes`) must fit twice in shared memory
    (:func:`ring_stages`).  ``launches`` counts the kernel launches this
    wrapper made, one a call."""
    if not q.is_cuda:
        raise ValueError(
            "paged_attention_ring launches a CUDA kernel and takes CUDA "
            f"tensors only (q is on {q.device}); kernels.ops dispatches CPU "
            "tensors to the plain versions")
    decode = q.dim() == 4
    q5 = q[:, None] if decode else q
    B, T, KV, G, hd, page_size, n_blocks, store = _gqa_slab_shapes(
        q5, k_pool, v_pool, block_tables, pos, k_scale, v_scale)
    dev = q.device
    out = torch.empty_like(q5)
    if q.dtype == torch.bfloat16:
        err = gqa_core_run(q5, k_pool, v_pool, k_scale, v_scale, block_tables,
                        pos, out,
                        stages=gqa_core_stages(hd, store != 0, page_size),
                        scale=scale, soft_cap=soft_cap, store=store)
    else:
        stages = ring_stages(gqa_ring_stage_bytes(
            page_size, hd, k_pool.element_size(), store != 0), n_blocks)
        lib = build.library("paged_attention_ring", RING_C_SIGNATURES)
        err = lib.paged_attention_ring(
            q5.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, T, KV, G, hd, page_size,
            n_blocks, stages, float(scale), float(soft_cap),
            _DTYPE_CODES[q.dtype], store,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_ring kernel launch failed: "
                           f"CUDA error {err}")
    paged_attention_ring.launches += 1
    return out[:, 0] if decode else out


paged_attention_ring.launches = 0

# the C interface of csrc/paged_attention_ring.cu
RING_C_SIGNATURES = {
    "paged_attention_ring": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
        ctypes.c_int),
}


def mla_paged_attention_ring(
    q_lat: torch.Tensor, q_rope: torch.Tensor, c_pool: torch.Tensor,
    r_pool: torch.Tensor, block_tables: torch.Tensor, pos: torch.Tensor, *,
    scale: float,
    c_scale: Optional[torch.Tensor] = None,
    r_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA MLA ring kernel (``csrc/mla_paged_attention_ring.cu``)
    on the current stream (no sync): decode with q_lat (B, H, r) / q_rope
    (B, H, dr), the contract of :func:`mla_paged_attention_reference`, or
    verification with q_lat (B, T, H, r) / q_rope (B, T, H, dr), that of
    :func:`mla_paged_attention_verify_reference`.  The output equals
    :func:`mla_paged_attention` / :func:`mla_paged_attention_verify` bit for
    bit, on quantized pools too.  The same sets as those: bf16 or f32
    queries, pools in their dtype or int8 / float8_e4m3fn with float32
    scale pools (P, page), latent rank in ``MLA_LATENT_DIMS``, rope dim in
    ``MLA_ROPE_DIMS``, page size in ``MLA_PAGE_SIZES``, any head count and
    T >= 1.  bf16 runs the off walks' tensor-core core
    (``csrc/mla_core.cu``) with :func:`mla_core_stages` tiles in flight.
    ``launches`` counts the kernel launches this wrapper made
    (:func:`mla_launches_per_call` a call)."""
    if not q_lat.is_cuda:
        raise ValueError(
            "mla_paged_attention_ring launches a CUDA kernel and takes CUDA "
            f"tensors only (q_lat is on {q_lat.device}); kernels.ops "
            "dispatches CPU tensors to the plain versions")
    decode = q_lat.dim() == 3
    ql4 = q_lat[:, None] if decode else q_lat
    qr4 = q_rope[:, None] if decode else q_rope
    B, T, H, r, dr, page_size, n_blocks, store = _mla_slab_shapes(
        ql4, qr4, c_pool, r_pool, block_tables, pos, c_scale, r_scale)
    dev = q_lat.device
    out = torch.empty_like(ql4)
    if q_lat.dtype == torch.bfloat16:
        err = _mla_core(ql4, qr4, c_pool, r_pool, c_scale, r_scale,
                        block_tables, pos, out,
                        stages=mla_core_stages(r, dr, store != 0, page_size),
                        scale=scale, store=store)
    else:
        stages = ring_stages(mla_ring_stage_bytes(
            r, dr, c_pool.element_size(), store != 0), n_blocks)
        lib = build.library("mla_paged_attention_ring", MLA_RING_C_SIGNATURES)
        err = lib.mla_paged_attention_ring(
            ql4.data_ptr(), qr4.data_ptr(), c_pool.data_ptr(),
            r_pool.data_ptr(), _ptr(c_scale), _ptr(r_scale),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, T, H,
            r, dr, page_size, n_blocks, stages, float(scale),
            _DTYPE_CODES[q_lat.dtype], store,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_paged_attention_ring kernel launch failed: "
                           f"CUDA error {err}")
    mla_paged_attention_ring.launches += mla_launches_per_call(q_lat.dtype)
    return out[:, 0] if decode else out


mla_paged_attention_ring.launches = 0

# the C interface of csrc/mla_paged_attention_ring.cu
MLA_RING_C_SIGNATURES = {
    "mla_paged_attention_ring": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
}


# --------------------------------------------------------------------------
# On-chip bytes of the CUDA kernels (the scheduler's per-token ``vmem``
# ledger)
#
# What one call moves between L2 and the SMs, the level the L2-resident
# probe (csrc/l2_probe.cu) prices, counted from the sources' tile loops:
# each working block's staged K / V (latent + rope) lines with their
# scales, the query rows each block loads, the split-K partials written to
# the workspace and read back by the merge, and the output written.  A
# block counts each global byte it loads or stores once.  Blocks with no
# lines (past a slot's walk) return at once and move nothing.  Block-table
# entries, positions and the GQA core's counters (4 bytes a page, a slot,
# a row group) are left out.  Per slot and layer, for ``context_len`` L:
# the slot's first query sits at L - 1 (decode: lines 0 .. L - 1).
# --------------------------------------------------------------------------

def _visible(context_len: int, t: int, n_blocks: Optional[int],
             page_size: int) -> int:
    """Lines query t of a slot at ``context_len`` sees: pos + t + 1 with
    pos = L - 1, at most the table's lines."""
    n = int(context_len) + int(t)
    return n if n_blocks is None else min(n, int(n_blocks) * int(page_size))


def f32_row_tile(rows: int) -> int:
    """Rows a block of the float32 GQA verify / ring kernels holds
    (``dispatch_rows`` in csrc/paged_attention_verify.cu and
    csrc/paged_attention_ring.cu)."""
    return 1 if rows <= 1 else 2 if rows <= 2 else 4 if rows <= 4 else 8


def gqa_merge_read(head_dim: int) -> int:
    """Bytes the GQA core's merge reads of one row's partials of one
    chunk.  Its loads are ``__ldcg`` (L2, past L1), so every load
    instruction is a read of its own, counted as the distinct bytes a
    warp's threads address (threads of a warp on one address are one
    request): a thread a row reads the chunk's m (4 bytes) for the row's
    maximum; then each of the head_dim / 4 threads of the row reads (m, l)
    (8 bytes, once per warp the row spans: head_dim / 128 warps, at least
    one) and its own 4 columns of acc (4 x head_dim bytes in all).  Sector
    rounding (32 bytes) is not counted."""
    hd = int(head_dim)
    return 4 + 8 * max(1, hd // 128) + 4 * hd


def gqa_onchip_bytes(context_len: int, *, page_size: int, kv_heads: int,
                     groups: int, head_dim: int, isize: int, kv_isize: int,
                     quantized: bool = False, n_q: int = 1,
                     pipeline: str = "off",
                     n_blocks: Optional[int] = None) -> float:
    """On-chip bytes one slot's GQA call moves for one layer, in the kernel
    that queries of ``isize`` bytes dispatch to: bf16 (2) the tensor-core
    core ``csrc/gqa_core.cu`` whatever the pipeline (its stages change
    overlap, not bytes); float32 (4) ``csrc/paged_attention.cu`` (decode,
    off), ``csrc/paged_attention_verify.cu`` (``n_q`` > 1, off) or the ring
    ``csrc/paged_attention_ring.cu`` (``pipeline="double"``), which stages
    whole pages.  A K and a V line are ``head_dim * kv_isize`` bytes each,
    plus their two float32 scales when ``quantized``.  The core's split-K
    partials cross L2 twice when a call takes several chunks: written
    once, read by the merge as :func:`gqa_merge_read` counts."""
    T, G, hd, KV = int(n_q), int(groups), int(head_dim), int(kv_heads)
    rows = T * G
    line = 2 * hd * int(kv_isize) + (8 if quantized else 0)
    n = _visible(context_len, T - 1, n_blocks, page_size)
    if isize == 2:
        nc = -(-n // (GQA_CHUNK_PAGES * int(page_size)))
        tiles = -(-rows // GQA_ROW_TILE)
        total = nc * rows * hd * 2 + tiles * n * line + rows * hd * 2
        if nc > 1:                    # partials written, read by the merge
            total += nc * rows * (4 * hd + 8) + nc * rows * gqa_merge_read(hd)
        return float(KV * total)
    qo = 2 * rows * hd * int(isize)
    if pipeline == "off" and T == 1:
        return float(KV * (qo + n * line))
    R = f32_row_tile(rows)
    walk = 0
    for row0 in range(0, rows, R):
        nr = min(R, rows - row0)
        nl = _visible(context_len, (row0 + nr - 1) // G, n_blocks, page_size)
        if pipeline == "double":
            nl = -(-nl // int(page_size)) * int(page_size)
        walk += nl * line
    return float(KV * (qo + walk))


def mla_onchip_bytes(context_len: int, *, page_size: int, n_heads: int,
                     lora_rank: int, rope_dim: int, isize: int, kv_isize: int,
                     quantized: bool = False, n_q: int = 1,
                     pipeline: str = "off",
                     n_blocks: Optional[int] = None) -> float:
    """On-chip bytes one slot's MLA call moves for one layer: bf16 queries
    (``isize`` 2) on the tensor-core core ``csrc/mla_core.cu`` (every one of
    a chunk's ``MLA_COLUMN_PART``-column parts stages the query rows and
    the whole latent + rope tile again; each chunk's float32 partials are
    written and the merge kernel reads them back, one (head, token) a
    block: its threads' repeated loads of a chunk's (m, l) are plain
    loads, which L1 serves, so they count once), whatever the pipeline; float32 on the CUDA-core kernels
    (``csrc/mla_paged_attention{,_verify,_ring}.cu``: one block per 8
    heads of a token, each staging the token's visible lines; the ring's
    16-line tiles stop at the last visible line, so its bytes are the off
    kernels').  A line is ``(lora_rank + rope_dim) * kv_isize`` bytes, plus
    two float32 scales when ``quantized``."""
    H, r, dr = int(n_heads), int(lora_rank), int(rope_dim)
    line = (r + dr) * int(kv_isize) + (8 if quantized else 0)
    total = 0
    for t in range(int(n_q)):
        n = _visible(context_len, t, n_blocks, page_size)
        if isize == 2:
            rp = -(-r // 64) * 64
            parts = rp // min(rp, MLA_COLUMN_PART)
            tiles = -(-H // MLA_HEAD_TILE)
            nc = -(-n // (MLA_CHUNK_PAGES * int(page_size)))
            total += (nc * parts * H * (r + dr) * 2 + parts * tiles * n * line
                      + 2 * nc * H * (4 * r + 8) + H * r * 2)
        else:
            blocks = -(-H // MLA_HEADS_PER_BLOCK)
            total += (H * (r + dr) * int(isize) + blocks * n * line
                      + H * r * int(isize))
    return float(total)


# --------------------------------------------------------------------------
# The reference's TPU pricing
#
# Derived from the Pallas kernels' grids and scratch on the TPU (the
# single-buffered grid (B, KV, n_blocks) for pipeline="off", the two-slab
# walk for "double"); kept verbatim and held equal to the reference's.
# They price the reference's TPU grid, not the CUDA kernels' traffic
# (:func:`gqa_onchip_bytes`, :func:`mla_onchip_bytes` are that).
# --------------------------------------------------------------------------

def live_blocks(context_len: int, page_size: int, n_q: int = 1) -> int:
    """Pages holding live KV for a slot whose LAST query sits at position
    ``context_len + n_q - 2`` (decode: n_q=1 -> lines 0..L-1)."""
    lines = max(1, int(context_len) + int(n_q) - 1)
    return -(-lines // int(page_size))


def paged_decode_vmem_bytes(
    *, context_len: int, page_size: int, n_heads: int, kv_heads: int,
    head_dim: int, isize: int, n_q: int = 1, pipeline: str = "off",
    kv_isize: int = 0, scale_isize: int = 0,
) -> float:
    """VMEM bytes one slot moves in the reference's TPU GQA paged decode
    (``n_q == 1``) or verify (``n_q == T``) walk: streamed K/V slabs,
    query re-reads per block step (once per program with
    ``pipeline="double"``, whose walk runs inside one program), float32
    softmax carries read and written per block step, the output flush and
    the appended lines.  Not a count of the CUDA kernels' traffic."""
    g = n_heads // kv_heads
    rows = g * n_q
    nb = live_blocks(context_len, page_size, n_q)
    q_steps = nb if pipeline == "off" else 1
    kv_line = head_dim * (kv_isize or isize) + scale_isize
    stream = kv_heads * nb * 2 * page_size * kv_line
    q_reread = kv_heads * q_steps * rows * head_dim * isize
    carries = kv_heads * nb * 2 * rows * (head_dim + 2) * 4
    out = kv_heads * rows * head_dim * isize
    appended = n_q * 2 * kv_heads * kv_line
    return float(stream + q_reread + carries + out + appended)


def mla_paged_decode_vmem_bytes(
    *, context_len: int, page_size: int, n_heads: int, lora_rank: int,
    rope_dim: int, isize: int, n_q: int = 1, pipeline: str = "off",
    kv_isize: int = 0, scale_isize: int = 0,
) -> float:
    """VMEM bytes one slot moves in the reference's TPU MLA paged decode /
    verify walk: streamed latent + rope lines, query re-reads per block
    step (once per program with ``pipeline="double"``), float32 softmax
    carries read and written per block step, the output flush and the
    appended lines.  Not a count of the CUDA kernels' traffic."""
    rows = n_heads * n_q
    nb = live_blocks(context_len, page_size, n_q)
    q_steps = nb if pipeline == "off" else 1
    line = (lora_rank + rope_dim) * isize
    kv_line = (lora_rank + rope_dim) * (kv_isize or isize) + 2 * scale_isize
    stream = nb * page_size * kv_line
    q_reread = q_steps * rows * line
    carries = nb * 2 * rows * (lora_rank + 2) * 4
    out = rows * lora_rank * isize
    appended = n_q * kv_line
    return float(stream + q_reread + carries + out + appended)
