"""GQA self-attention (+qk-norm, RoPE) and gated cross-attention over full
sequences, paged KV caches and the static engine's dense caches.  MLA
lives in ``mla.py``.

The attention core is plain PyTorch ops, as the reference's is plain jnp
outside any kernel; only decode and multi-token verification go through
hand-written kernels (kernels/ops.py ``paged_attention`` and
``paged_attention_verify``).  The static engine's dense caches
(B, Smax_r, KV, hd), their sequence axis rounded up to a multiple of
``DENSE_PAGE``, are viewed without a copy as a page pool under an
identity block table (:func:`dense_attention`), so its self and cross
decode attention run the same kernel as the paged engine (the reference
attends them with plain jnp).  KV heads stay un-repeated: the query-group
dim G rides along so GQA never materializes repeated K/V.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.roofline.op_cost import named_scope
from ..kernels import ops as kernel_ops
from ..kernels import quantize as kvq
from ..parallel.collectives import row_parallel_matmul
from .common import ModelConfig
from .layers import apply_rope, rms_head_norm, rope_cos_sin
from .params import ParamDef, torch_dtype

NEG_INF = -1e30

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def attn_defs(cfg: ModelConfig, cross: bool = False
              ) -> Dict[str, ParamDef]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype
    defs = {
        "wq": ParamDef((D, H, hd), dt, fan_in_axes=(0,),
                       logical=("d_model", "heads", "head_dim")),
        "wk": ParamDef((D, KV, hd), dt, fan_in_axes=(0,),
                       logical=("d_model", "kv_heads", "head_dim")),
        "wv": ParamDef((D, KV, hd), dt, fan_in_axes=(0,),
                       logical=("d_model", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, D), dt, fan_in_axes=(0, 1),
                       logical=("heads", "head_dim", "d_model")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), "float32", init="ones",
                                  logical=("head_dim",))
        defs["k_norm"] = ParamDef((hd,), "float32", init="ones",
                                  logical=("head_dim",))
    if cross:
        # tanh-gated residual (llama-3.2-vision style, init 0 = identity)
        defs["gate"] = ParamDef((), "float32", init="zeros", logical=())
    return defs


def rope_tables(cfg: ModelConfig, positions: torch.Tensor) -> Rope:
    """RoPE cos/sin for ``positions`` (..., S), or None without RoPE.
    Every layer sees the same positions, so a forward pass computes them
    once and hands them to each layer (the reference recomputes them per
    layer, with the same values)."""
    if cfg.pos_emb != "rope":
        return None
    return rope_cos_sin(positions, cfg.hd, cfg.rope_theta)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, N, hd) -> (B, S, N, hd)."""
    B, S, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(B, S, *w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, D) -> (B, S, D).  Under tensor parallelism
    (``cfg.tp_axis``) the rank holds its heads only, so the product is a
    partial sum: the row-parallel edge all-reduces it over the axis (the
    reference's o-projection psum), or runs it as the ring matmul with
    ``cfg.tp_overlap`` "ring"."""
    B, S = o.shape[:2]
    return row_parallel_matmul(o.reshape(B, S, -1),
                               wo.reshape(-1, wo.shape[-1]), cfg.tp_axis,
                               cfg.tp_overlap)


def _project_qkv(p, x: torch.Tensor, kv_src: torch.Tensor, cfg: ModelConfig,
                 rope_q: Rope, rope_k: Rope):
    """q from ``x``, k and v from ``kv_src`` (x itself for self-attention),
    (B, S, heads, hd), with qk-norm; RoPE only on a side whose tables are
    given (cross-attention passes none)."""
    q = _heads(x, p["wq"])
    k, v = _heads(kv_src, p["wk"]), _heads(kv_src, p["wv"])
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope_q is not None:
        q = apply_rope(q, *rope_q)
    if rope_k is not None:
        k = apply_rope(k, *rope_k)
    return q, k, v


def _attn_core(q, k, v, q_pos, k_pos, *, causal: bool, scale: float,
               soft_cap: float = 0.0) -> torch.Tensor:
    """q (B,Sq,KV,G,hd)  k,v (B,Sk,KV,hd)  ->  (B,Sq,KV,G,hd)."""
    with named_scope("fused_attention"):
        s = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale
        if soft_cap > 0:
            s = torch.tanh(s / soft_cap) * soft_cap
        if causal:
            m = q_pos[:, :, None] >= k_pos[:, None, :]          # (B, Sq, Sk)
            s = torch.where(m[:, None, None, :, :], s, NEG_INF)
        p_attn = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bkgqs,bskh->bqkgh", p_attn, v)


def multihead_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                        positions: Optional[torch.Tensor], rope: Rope,
                        kv_src: Optional[torch.Tensor] = None,
                        causal: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (prefill, encoder).  x (B, S, D),
    positions (B, S) or None (``arange``), ``rope`` = rope_tables(cfg,
    positions) or None.  With ``kv_src`` (B, Sk, D) it is cross-attention:
    no RoPE, not causal, and the output scaled by ``tanh(gate)``; else
    causal as ``cfg.causal`` unless ``causal`` says otherwise.  Returns
    (out (B, S, D), {"k", "v"} (B, Sk, KV, hd)) — the K/V lines a prefill
    collects (qk-normed and RoPE'd as attended)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    cross = kv_src is not None
    src = kv_src if cross else x
    causal = (cfg.causal and not cross) if causal is None else causal
    rope = None if cross else rope
    q, k, v = _project_qkv(p, x, src, cfg, rope, rope)
    q = q.reshape(B, S, KV, G, hd)
    scale = 1.0 / (hd ** 0.5)
    Sk = src.shape[1]
    q_pos = k_pos = None
    if causal:
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        q_pos = positions
        k_pos = (positions if Sk == S else torch.arange(
            Sk, dtype=torch.int32, device=x.device).expand(B, Sk))
    chunk = cfg.attn_chunk
    if S > 2 * chunk and S % chunk == 0:
        # query chunks bound the score matrix to (B, KV, G, chunk, Sk)
        o = torch.cat([
            _attn_core(q[:, i:i + chunk], k, v,
                       None if q_pos is None else q_pos[:, i:i + chunk],
                       k_pos, causal=causal, scale=scale,
                       soft_cap=cfg.attn_logit_soft_cap)
            for i in range(0, S, chunk)], dim=1)
    else:
        o = _attn_core(q, k, v, q_pos, k_pos, causal=causal, scale=scale,
                       soft_cap=cfg.attn_logit_soft_cap)
    out = _out_proj(o, p["wo"], cfg)
    if cross and "gate" in p:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out, {"k": k, "v": v}


# --------------------------------------------------------------------------
# Paged KV cache
# --------------------------------------------------------------------------

def paged_pool_defs(cfg: ModelConfig, num_pages: int, page_size: int
                    ) -> Dict[str, ParamDef]:
    """Physical page pool for the GQA KV cache: (num_pages, page_size, KV,
    hd).  Pages carry no batch dim — a per-slot block table maps logical
    block -> physical page, shared across layers.

    With ``cfg.kv_dtype`` quantized (int8 / fp8_e4m3) the k/v pools store
    codes plus float32 absmax scales per (page, line, kv_head), initialised
    to ones so never-written lines dequantize to 0; the scale leaves are
    ordinary paged leaves (CoW, swap and preemption move them with the
    codes)."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    store = kvq.store_dtype(cfg.kv_dtype, cfg.dtype)
    shape = (num_pages, page_size, KV, hd)
    axes = ("none", "kv_seq", "kv_heads", "head_dim")
    defs = {"k": ParamDef(shape, store, init="zeros", logical=axes),
            "v": ParamDef(shape, store, init="zeros", logical=axes)}
    if kvq.is_quantized(cfg.kv_dtype):
        for name in ("k_scale", "v_scale"):
            defs[name] = ParamDef(shape[:-1], "float32", init="ones",
                                  logical=axes[:-1])
    return defs


def _commit_kv(pool: Dict[str, torch.Tensor], name: str, blk: torch.Tensor,
               off: torch.Tensor, new: torch.Tensor, kv_dtype: str) -> None:
    """Write new K or V (latent / rope) lines into the page pool IN PLACE
    (``index_put_``; the reference returns an updated pool instead),
    quantizing on the way in when the pool has a ``{name}_scale`` leaf.
    ``new`` (..., line) indexed by ``blk``/``off`` of matching leading
    shape.  Idle lanes all write trash page 0, line 0; which of them lands
    there is irrelevant."""
    idx = (blk.long(), off.long())
    if f"{name}_scale" in pool:
        q, s = kvq.quantize(new, kv_dtype, -1)
        pool[name].index_put_(idx, q)
        pool[f"{name}_scale"].index_put_(idx, s)
    else:
        pool[name].index_put_(idx, new.to(pool[name].dtype))


def gather_pages(pool: Dict[str, torch.Tensor], name: str,
                 block_table: torch.Tensor, dtype: str) -> torch.Tensor:
    """One slot's pages of leaf ``name`` (n_blocks, page, ...), dequantized
    and cast to the model ``dtype`` when quantized: chunked prefill
    re-reads earlier chunks through the same values every later decode
    step sees."""
    bt = block_table.long()
    if f"{name}_scale" not in pool:
        return pool[name][bt]
    return kvq.dequantize(pool[name][bt], pool[f"{name}_scale"][bt]).to(
        torch_dtype(dtype))


def decode_attention_paged(
    p, x: torch.Tensor, pool: Dict[str, torch.Tensor],
    block_tables: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig, *,
    page_size: int, rope: Rope, pipeline: Optional[str] = None,
) -> torch.Tensor:
    """One-token decode for every slot against a paged pool (updated in
    place).  x (B,1,D); pool k/v (P, page, KV, hd); block_tables
    (B, n_blocks) int32; pos (B,) int32 per-slot write position; ``rope``
    = rope_tables(cfg, pos[:, None]).  Inactive slots map to the trash
    page and are discarded by the caller.  ``pipeline`` selects the
    kernel's page-streaming schedule (kernels/ops.py)."""
    B, _, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    q, k_new, v_new = _project_qkv(p, x, x, cfg, rope, rope)
    blk = torch.gather(block_tables, 1,
                       (pos[:, None] // page_size).long())[:, 0]
    off = pos % page_size
    _commit_kv(pool, "k", blk, off, k_new[:, 0], cfg.kv_dtype)
    _commit_kv(pool, "v", blk, off, v_new[:, 0], cfg.kv_dtype)
    with named_scope("paged_attention"):
        o = kernel_ops.paged_attention(
            q.reshape(B, KV, G, hd).contiguous(), pool["k"], pool["v"],
            block_tables, pos, scale=1.0 / (hd ** 0.5),
            soft_cap=cfg.attn_logit_soft_cap, k_scale=pool.get("k_scale"),
            v_scale=pool.get("v_scale"), pipeline=pipeline
        ).reshape(B, 1, H, hd)
    return _out_proj(o.to(x.dtype), p["wo"], cfg)


def decode_verify_paged(
    p, x: torch.Tensor, pool: Dict[str, torch.Tensor],
    block_tables: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig, *,
    page_size: int, rope: Rope, pipeline: Optional[str] = None,
) -> torch.Tensor:
    """Multi-token verification decode for every slot (speculative
    decoding), pool updated in place.  x (B, T, D): the draft chain [last
    committed token, d_1..d_k] at positions ``pos + t``; pos (B,) int32
    the first token's write position; ``rope`` = rope_tables(cfg,
    pos[:, None] + arange(T)).  Writes all T K/V lines, then scores all T
    queries in one page walk (``ops.paged_attention_verify``).  Writes past
    the slot's backed pages land on the trash page (table entries 0 there);
    rejected-draft lines are masked for every committed query and
    overwritten when a real token is fed at their position, so rollback is
    host-side position bookkeeping."""
    B, T, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    posq = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                       device=x.device)[None, :]  # (B, T)
    q, k_new, v_new = _project_qkv(p, x, x, cfg, rope, rope)
    n_blocks = block_tables.shape[1]
    blk_idx = torch.clamp(posq // page_size, max=n_blocks - 1)
    blk = torch.gather(block_tables, 1, blk_idx.long())           # (B, T)
    off = posq % page_size
    _commit_kv(pool, "k", blk, off, k_new, cfg.kv_dtype)
    _commit_kv(pool, "v", blk, off, v_new, cfg.kv_dtype)
    with named_scope("paged_attention"):
        o = kernel_ops.paged_attention_verify(
            q.reshape(B, T, KV, G, hd).contiguous(), pool["k"], pool["v"],
            block_tables, pos, scale=1.0 / (hd ** 0.5),
            soft_cap=cfg.attn_logit_soft_cap, k_scale=pool.get("k_scale"),
            v_scale=pool.get("v_scale"), pipeline=pipeline
        ).reshape(B, T, H, hd)
    return _out_proj(o.to(x.dtype), p["wo"], cfg)


def prefill_attention_paged(
    p, x: torch.Tensor, pool: Dict[str, torch.Tensor],
    block_table: torch.Tensor, offset, cfg: ModelConfig, *,
    page_size: int, rope: Rope,
) -> torch.Tensor:
    """Chunked prefill for ONE request: x (1,T,D) at positions
    offset..offset+T-1 (``rope`` for those; ``offset`` an int or a 0-d
    int32 device tensor), attending to everything this slot has cached
    (earlier chunks + causal self) over the whole table row, so no shape
    depends on ``offset``.  block_table (n_blocks,).  The pool is updated
    in place."""
    B, T, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    idx = offset + torch.arange(T, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, cfg, rope, rope)
    blk, off = block_table[idx.long() // page_size], idx % page_size
    _commit_kv(pool, "k", blk, off, k_new[0], cfg.kv_dtype)
    _commit_kv(pool, "v", blk, off, v_new[0], cfg.kv_dtype)
    S = block_table.shape[0] * page_size
    k = gather_pages(pool, "k", block_table, cfg.dtype).reshape(1, S, KV, hd)
    v = gather_pages(pool, "v", block_table, cfg.dtype).reshape(1, S, KV, hd)
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    o = _attn_core(q.reshape(B, T, KV, G, hd), k, v, idx[None, :], k_pos,
                   causal=True, scale=1.0 / (hd ** 0.5),
                   soft_cap=cfg.attn_logit_soft_cap).reshape(B, T, H, hd)
    return _out_proj(o, p["wo"], cfg)


# --------------------------------------------------------------------------
# Dense KV cache (the static engine)
# --------------------------------------------------------------------------

# lines a dense cache's sequence axis is rounded up to, and the page of the
# identity table that views it as a pool
DENSE_PAGE = 16


def dense_lines(n: int) -> int:
    """``n`` rounded up to a multiple of ``DENSE_PAGE``: the sequence axis
    of a dense cache of ``n`` lines (the extra lines stay zero and are
    never read)."""
    return -(-n // DENSE_PAGE) * DENSE_PAGE


def init_cache_defs(cfg: ModelConfig, batch: int, max_len: int
                    ) -> Dict[str, ParamDef]:
    """Dense decode cache k/v (batch, dense_lines(max_len), KV, hd),
    zeros."""
    shape = (batch, dense_lines(max_len), cfg.n_kv_heads, cfg.hd)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ParamDef(shape, cfg.dtype, init="zeros", logical=axes),
            "v": ParamDef(shape, cfg.dtype, init="zeros", logical=axes)}


def identity_tables(batch: int, lines: int, device) -> torch.Tensor:
    """The block table of a dense cache (batch, lines, ...) viewed as a
    pool of pages of ``DENSE_PAGE`` lines: row b's block j is page
    ``b * lines / DENSE_PAGE + j``.  (batch, n_blocks) int32."""
    nb = lines // DENSE_PAGE
    return torch.arange(batch * nb, dtype=torch.int32,
                        device=device).view(batch, nb)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor, *, scale: float,
                    soft_cap: float = 0.0) -> torch.Tensor:
    """One query token a row against dense caches k/v (B, Smax_r, KV, hd)
    through ``kernels.ops.paged_attention``: the caches viewed, without a
    copy, as a pool (B * Smax_r / DENSE_PAGE, DENSE_PAGE, KV, hd) under
    :func:`identity_tables`.  q (B, KV, G, hd); pos (B,) int32, the last
    line each row sees.  Returns (B, KV, G, hd)."""
    B, S, KV, hd = k.shape
    shape = (B * S // DENSE_PAGE, DENSE_PAGE, KV, hd)
    return kernel_ops.paged_attention(
        q.contiguous(), k.view(shape), v.view(shape),
        identity_tables(B, S, q.device), pos, scale=scale,
        soft_cap=soft_cap, pipeline="off")


def decode_attention(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: torch.Tensor, cfg: ModelConfig, *, rope: Rope
                     ) -> torch.Tensor:
    """One-token decode against a dense cache (updated in place).
    x (B,1,D); cache k/v (B, Smax_r, KV, hd); pos (B,) int32, the write
    position of each row (the reference's scalar, broadcast); ``rope`` =
    rope_tables(cfg, pos[:, None])."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k_new, v_new = _project_qkv(p, x, x, cfg, rope, rope)
    rows = torch.arange(B, device=x.device)
    cache["k"].index_put_((rows, pos.long()), k_new[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_((rows, pos.long()), v_new[:, 0].to(cache["v"].dtype))
    with named_scope("paged_attention"):
        o = dense_attention(q.reshape(B, KV, H // KV, hd), cache["k"],
                            cache["v"], pos, scale=1.0 / (hd ** 0.5),
                            soft_cap=cfg.attn_logit_soft_cap
                            ).reshape(B, 1, H, hd)
    return _out_proj(o.to(x.dtype), p["wo"], cfg)
