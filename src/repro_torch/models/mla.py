"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the JAX
package's ``models/mla.py`` in PyTorch.

KV is compressed to a per-token latent ``c_kv`` of rank ``kv_lora_rank``
plus one shared RoPE key of ``rope_head_dim``; per-head K/V are
re-expanded through ``wk_b`` / ``wv_b``.  The paged decode cache stores
only the latent and rope lines: pools (P, page, r) and (P, page, dr).

* :func:`mla_attention` — full-sequence expanded form (``forward_full``
  and whole-prompt prefill); also returns the latent lines it computed.
* :func:`mla_prefill_paged` — one prefill chunk against the paged pool,
  expanded or absorbed as ``cfg.mla_absorb`` says.
* :func:`mla_decode_paged` — one-token decode, always in the absorbed
  (latent-space) form; its attention core is ``kernels/ops.py``
  ``mla_paged_attention``, the hand-written CUDA kernel on the card.
* :func:`mla_decode_verify_paged` — T-token verification (speculative
  decoding), absorbed; its core is ``ops.mla_paged_attention_verify``.
* :func:`mla_decode` — one-token decode against the static engine's
  dense latent cache (:func:`mla_cache_defs`), absorbed or expanded as
  ``cfg.mla_absorb`` says, in plain PyTorch as the reference's is jnp.

RoPE tables are computed once per forward at ``rope_head_dim``
(:func:`rope_tables`) and passed in, where the reference recomputes them
from positions inside every call.  The pools are updated in place by the
GQA path's ``_commit_kv`` (the reference's ``_commit_latent``); the
reference's ``_rms`` is ``layers.rms_head_norm``.  The dense cache's
sequence axis is rounded up as the GQA one is (``attention.dense_lines``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.roofline.op_cost import named_scope
from ..kernels import ops as kernel_ops
from ..kernels import quantize as kvq
from .attention import (NEG_INF, Rope, _commit_kv, _heads, _out_proj,
                        dense_lines, gather_pages)
from .common import ModelConfig
from .layers import rms_head_norm, rope_cos_sin
from .params import ParamDef


def rope_tables(cfg: ModelConfig, positions: torch.Tensor) -> Rope:
    """MLA RoPE cos/sin for ``positions`` (..., S) at ``rope_head_dim``."""
    return rope_cos_sin(positions, cfg.rope_head_dim, cfg.rope_theta)


def _rope_pairs(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """Half-split RoPE over the last dim of x (..., S, [H,] r); cos/sin
    (..., S, r/2) gain a head axis when x has one."""
    cos, sin = rope
    r = x.shape[-1]
    while cos.dim() < x.dim():
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., : r // 2], x[..., r // 2:]
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def mla_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, H = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    dt = cfg.dtype
    defs: Dict[str, ParamDef] = {}
    if r_q:
        defs["wq_a"] = ParamDef((D, r_q), dt, logical=("d_model", "none"))
        defs["q_a_norm"] = ParamDef((r_q,), "float32", init="ones",
                                    logical=("none",))
        defs["wq_b"] = ParamDef((r_q, H, dn + dr), dt, fan_in_axes=(0,),
                                logical=("none", "heads", "head_dim"))
    else:
        defs["wq"] = ParamDef((D, H, dn + dr), dt, fan_in_axes=(0,),
                              logical=("d_model", "heads", "head_dim"))
    defs["wkv_a"] = ParamDef((D, r_kv + dr), dt, logical=("d_model", "none"))
    defs["kv_a_norm"] = ParamDef((r_kv,), "float32", init="ones",
                                 logical=("none",))
    defs["wk_b"] = ParamDef((r_kv, H, dn), dt, fan_in_axes=(0,),
                            logical=("none", "heads", "head_dim"))
    defs["wv_b"] = ParamDef((r_kv, H, dv), dt, fan_in_axes=(0,),
                            logical=("none", "heads", "head_dim"))
    defs["wo"] = ParamDef((H, dv, D), dt, fan_in_axes=(0, 1),
                          logical=("heads", "head_dim", "d_model"))
    return defs


def _queries(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
             rope: Rope = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q_nope (B,S,H,dn) and RoPE'd q_rope (B,S,H,dr); ``rope`` =
    rope_tables(cfg, pos), computed here when not given."""
    dn = cfg.nope_head_dim
    if rope is None:
        rope = rope_tables(cfg, pos)
    if cfg.q_lora_rank:
        cq = rms_head_norm(p["q_a_norm"], x @ p["wq_a"], cfg.norm_eps)
        q = _heads(cq, p["wq_b"])
    else:
        q = _heads(x, p["wq"])
    return q[..., :dn], _rope_pairs(q[..., dn:], rope)


def _latent_kv(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
               rope: Rope = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent line c_kv (B,S,r) and the RoPE'd shared key (B,S,dr)."""
    r_kv = cfg.kv_lora_rank
    if rope is None:
        rope = rope_tables(cfg, pos)
    ckv = x @ p["wkv_a"]                              # (B, S, r+dr)
    c_kv = rms_head_norm(p["kv_a_norm"], ckv[..., :r_kv], cfg.norm_eps)
    return c_kv, _rope_pairs(ckv[..., r_kv:], rope)


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig,
                  q_positions: Optional[torch.Tensor] = None, *,
                  rope: Rope = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence causal MLA with K, V expanded per head.  x (B, S, D).
    Returns (out (B, S, D), {"c_kv" (B,S,r), "k_rope" (B,S,dr)}) — the
    latent lines a prefill collects."""
    B, S, _ = x.shape
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    if q_positions is None:
        q_positions = torch.arange(S, dtype=torch.int32,
                                   device=x.device).expand(B, S)
    if rope is None:
        rope = rope_tables(cfg, q_positions)
    q_nope, q_rope = _queries(p, x, q_positions, cfg, rope)
    c_kv, k_rope = _latent_kv(p, x, q_positions, cfg, rope)
    k_nope = _heads(c_kv, p["wk_b"])                  # (B, S, H, dn)
    v = _heads(c_kv, p["wv_b"])                       # (B, S, H, dv)
    scale = 1.0 / ((dn + dr) ** 0.5)

    def chunk_attn(qn, qr, qp):
        with named_scope("fused_attention"):
            s = (torch.einsum("bqhk,bshk->bhqs", qn, k_nope)
                 + torch.einsum("bqhk,bsk->bhqs", qr, k_rope))
            s = s.float() * scale
            m = qp[:, :, None] >= q_positions[:, None, :]
            s = torch.where(m[:, None, :, :], s, NEG_INF)
            w = torch.softmax(s, dim=-1).to(v.dtype)
            return torch.einsum("bhqs,bshk->bqhk", w, v)

    chunk = cfg.attn_chunk
    if S > 2 * chunk and S % chunk == 0:
        o = torch.cat([chunk_attn(q_nope[:, i:i + chunk],
                                  q_rope[:, i:i + chunk],
                                  q_positions[:, i:i + chunk])
                       for i in range(0, S, chunk)], dim=1)
    else:
        o = chunk_attn(q_nope, q_rope, q_positions)
    return _out_proj(o, p["wo"], cfg), {"c_kv": c_kv, "k_rope": k_rope}


# --------------------------------------------------------------------------
# Paged latent cache
# --------------------------------------------------------------------------

def mla_paged_pool_defs(cfg: ModelConfig, num_pages: int, page_size: int
                        ) -> Dict[str, ParamDef]:
    """Physical page pools for the latent cache: (num_pages, page, r) and
    (num_pages, page, dr), addressed through the same block tables as the
    GQA pools.  With ``cfg.kv_dtype`` quantized each pool stores codes
    plus a float32 absmax scale per (page, line) — the latent vector is
    one quantization group — initialised to ones."""
    store = kvq.store_dtype(cfg.kv_dtype, cfg.dtype)
    defs = {
        "c_kv": ParamDef((num_pages, page_size, cfg.kv_lora_rank), store,
                         init="zeros", logical=("none", "kv_seq", "none")),
        "k_rope": ParamDef((num_pages, page_size, cfg.rope_head_dim), store,
                           init="zeros", logical=("none", "kv_seq", "none")),
    }
    if kvq.is_quantized(cfg.kv_dtype):
        for name in ("c_kv_scale", "k_rope_scale"):
            defs[name] = ParamDef((num_pages, page_size), "float32",
                                  init="ones", logical=("none", "kv_seq"))
    return defs


def _mla_attend(p, q_nope: torch.Tensor, q_rope: torch.Tensor,
                c_kv: torch.Tensor, k_rope: torch.Tensor,
                valid: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Shared paged-attention core.  q_* (B,T,H,*); c_kv (B,S,r);
    k_rope (B,S,dr); valid (B,T,S) bool.  Returns (B, T, D)."""
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    scale = 1.0 / ((dn + dr) ** 0.5)
    if cfg.mla_absorb:
        q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"])
        s = (torch.einsum("bqhr,bsr->bhqs", q_lat, c_kv)
             + torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope))
        s = torch.where(valid[:, None], s.float() * scale, NEG_INF)
        w = torch.softmax(s, dim=-1).to(c_kv.dtype)
        o_lat = torch.einsum("bhqs,bsr->bqhr", w, c_kv)
        o = torch.einsum("bqhr,rhk->bqhk", o_lat, p["wv_b"])
    else:
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"])
        v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"])
        s = (torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope)
             + torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope))
        s = torch.where(valid[:, None], s.float() * scale, NEG_INF)
        w = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqs,bshk->bqhk", w, v)
    return _out_proj(o, p["wo"], cfg)


def mla_decode_paged(p, x: torch.Tensor, pool: Dict[str, torch.Tensor],
                     block_tables: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, *, page_size: int, rope: Rope = None,
                     pipeline: Optional[str] = None) -> torch.Tensor:
    """One-token MLA decode for every slot against the paged latent pool
    (updated in place).  x (B,1,D); pool c_kv (P,page,r) / k_rope
    (P,page,dr); block_tables (B,n_blocks) int32; pos (B,) int32; ``rope``
    = rope_tables(cfg, pos[:, None]).

    Always the absorbed form, whatever ``cfg.mla_absorb`` says: fold
    ``wk_b`` into q, attend against the latent lines directly (the
    kernel), fold ``wv_b`` back out — the same function as the per-head
    re-expansion, with the fewest bytes read."""
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    posb = pos[:, None]
    if rope is None:
        rope = rope_tables(cfg, posb)
    q_nope, q_rope = _queries(p, x, posb, cfg, rope)
    c_new, kr_new = _latent_kv(p, x, posb, cfg, rope)
    blk = torch.gather(block_tables, 1, (posb // page_size).long())[:, 0]
    off = pos % page_size
    _commit_kv(pool, "c_kv", blk, off, c_new[:, 0], cfg.kv_dtype)
    _commit_kv(pool, "k_rope", blk, off, kr_new[:, 0], cfg.kv_dtype)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], p["wk_b"])  # (B,H,r)
    with named_scope("paged_attention"):
        o_lat = kernel_ops.mla_paged_attention(
            q_lat.contiguous(), q_rope[:, 0].contiguous(), pool["c_kv"],
            pool["k_rope"], block_tables, pos,
            scale=1.0 / ((dn + dr) ** 0.5), c_scale=pool.get("c_kv_scale"),
            r_scale=pool.get("k_rope_scale"), pipeline=pipeline)  # (B,H,r)
    o = torch.einsum("bhr,rhk->bhk", o_lat.to(x.dtype), p["wv_b"])
    return _out_proj(o[:, None], p["wo"], cfg)


def mla_decode_verify_paged(p, x: torch.Tensor,
                            pool: Dict[str, torch.Tensor],
                            block_tables: torch.Tensor, pos: torch.Tensor,
                            cfg: ModelConfig, *, page_size: int,
                            rope: Rope = None,
                            pipeline: Optional[str] = None) -> torch.Tensor:
    """Multi-token MLA verification against the paged latent pool
    (speculative decoding), pool updated in place.  x (B, T, D) draft-chain
    tokens at positions ``pos + t``; pos (B,) int32 the first token's
    write position; ``rope`` = rope_tables(cfg, pos[:, None] + arange(T)).
    Absorbed form, as :func:`mla_decode_paged`: all T latent lines are
    written, then all T queries share one page walk
    (``ops.mla_paged_attention_verify``); rollback of rejected drafts is
    position bookkeeping (attention.decode_verify_paged)."""
    T = x.shape[1]
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    posq = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                       device=x.device)[None, :]  # (B, T)
    if rope is None:
        rope = rope_tables(cfg, posq)
    q_nope, q_rope = _queries(p, x, posq, cfg, rope)             # (B,T,H,*)
    c_new, kr_new = _latent_kv(p, x, posq, cfg, rope)            # (B,T,*)
    n_blocks = block_tables.shape[1]
    blk_idx = torch.clamp(posq // page_size, max=n_blocks - 1)
    blk = torch.gather(block_tables, 1, blk_idx.long())
    off = posq % page_size
    _commit_kv(pool, "c_kv", blk, off, c_new, cfg.kv_dtype)
    _commit_kv(pool, "k_rope", blk, off, kr_new, cfg.kv_dtype)
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, p["wk_b"])    # (B,T,H,r)
    with named_scope("paged_attention"):
        o_lat = kernel_ops.mla_paged_attention_verify(
            q_lat.contiguous(), q_rope.contiguous(), pool["c_kv"],
            pool["k_rope"], block_tables, pos,
            scale=1.0 / ((dn + dr) ** 0.5), c_scale=pool.get("c_kv_scale"),
            r_scale=pool.get("k_rope_scale"), pipeline=pipeline)  # (B,T,H,r)
    o = torch.einsum("bqhr,rhk->bqhk", o_lat.to(x.dtype), p["wv_b"])
    return _out_proj(o, p["wo"], cfg)


def mla_prefill_paged(p, x: torch.Tensor, pool: Dict[str, torch.Tensor],
                      block_table: torch.Tensor, offset,
                      cfg: ModelConfig, *, page_size: int, rope: Rope = None
                      ) -> torch.Tensor:
    """Chunked MLA prefill for ONE request: x (1,T,D) at positions
    offset..offset+T-1 (``rope`` for those; ``offset`` an int or a 0-d
    int32 device tensor), attending to everything this slot has cached
    plus itself, causally, over the whole table row.  block_table
    (n_blocks,).  The pool is updated in place."""
    T = x.shape[1]
    idx = offset + torch.arange(T, dtype=torch.int32, device=x.device)
    if rope is None:
        rope = rope_tables(cfg, idx[None, :])
    q_nope, q_rope = _queries(p, x, idx[None, :], cfg, rope)
    c_new, kr_new = _latent_kv(p, x, idx[None, :], cfg, rope)
    blk, off = block_table[idx.long() // page_size], idx % page_size
    _commit_kv(pool, "c_kv", blk, off, c_new[0], cfg.kv_dtype)
    _commit_kv(pool, "k_rope", blk, off, kr_new[0], cfg.kv_dtype)
    S = block_table.shape[0] * page_size
    c_kv = gather_pages(pool, "c_kv", block_table, cfg.dtype).reshape(1, S, -1)
    k_rope = gather_pages(pool, "k_rope", block_table, cfg.dtype).reshape(
        1, S, -1)
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    valid = (idx[:, None] >= k_pos[None, :])[None]
    return _mla_attend(p, q_nope, q_rope, c_kv, k_rope, valid, cfg)


# --------------------------------------------------------------------------
# Dense latent cache (the static engine)
# --------------------------------------------------------------------------

def mla_cache_defs(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, ParamDef]:
    """Dense latent cache c_kv (batch, dense_lines(max_len), r) and k_rope
    (batch, dense_lines(max_len), dr), zeros."""
    S = dense_lines(max_len)
    axes = ("batch", "kv_seq", "none")
    return {"c_kv": ParamDef((batch, S, cfg.kv_lora_rank), cfg.dtype,
                             init="zeros", logical=axes),
            "k_rope": ParamDef((batch, S, cfg.rope_head_dim), cfg.dtype,
                               init="zeros", logical=axes)}


def mla_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, cfg: ModelConfig, *, rope: Rope = None
               ) -> torch.Tensor:
    """One-token MLA decode against the dense latent cache (updated in
    place).  x (B,1,D); cache c_kv (B, Smax_r, r) / k_rope (B, Smax_r,
    dr); pos (B,) int32 write positions; ``rope`` = rope_tables(cfg,
    pos[:, None]).  Absorbed or expanded per ``cfg.mla_absorb``, lines
    past ``pos`` masked: the reference's ``mla_decode``."""
    B = x.shape[0]
    posb = pos[:, None]
    if rope is None:
        rope = rope_tables(cfg, posb)
    q_nope, q_rope = _queries(p, x, posb, cfg, rope)             # (B,1,H,*)
    c_new, kr_new = _latent_kv(p, x, posb, cfg, rope)            # (B,1,*)
    rows = torch.arange(B, device=x.device)
    cache["c_kv"].index_put_((rows, pos.long()),
                             c_new[:, 0].to(cache["c_kv"].dtype))
    cache["k_rope"].index_put_((rows, pos.long()),
                               kr_new[:, 0].to(cache["k_rope"].dtype))
    k_pos = torch.arange(cache["c_kv"].shape[1], device=x.device)
    valid = (k_pos[None, :] <= pos.long()[:, None])[:, None, :]  # (B,1,S)
    return _mla_attend(p, q_nope, q_rope, cache["c_kv"], cache["k_rope"],
                       valid, cfg)
