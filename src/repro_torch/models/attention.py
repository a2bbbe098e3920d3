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

Under a mesh whose rules cut a dense cache's lines over ``model`` (KV
heads that do not divide it: a ``kv_seq`` layout, ``LocalLayout``) a
decode rank holds every KV head for its block of the lines, writes the
new line only where it owns the position, attends all query heads over
its block through the same kernel (which then also gives each row's
log-sum-exp) and merges the ranks' partial outputs
(``collectives.kv_merge``, flash-decoding) before the o-projection:
:func:`decode_attention` and :func:`cross_decode`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.roofline.op_cost import named_scope
from ..kernels import ops as kernel_ops
from ..kernels import quantize as kvq
from ..parallel.collectives import (head_gather, kv_merge,
                                    row_parallel_matmul, seq_gather,
                                    seq_slice, tp_copy)
from .common import ModelConfig, layout_of
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


def _kv_weight(w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``wk`` / ``wv`` (D, KV, hd) as this rank reads it.  Where the rules
    replicate the KV heads because they do not divide the tp axis (a
    ``kv_sliced`` layout, whose ``n_kv_heads`` is then 1), the rank's local
    query heads all read KV head ``coord x KV / tp``: the rank takes that
    slice, through ``tp_copy`` so that the ranks sharing a KV head sum
    their gradients (with one KV head, MQA, the slice is the whole
    weight, and the ``tp_copy`` all the same)."""
    if not layout_of(cfg).kv_sliced:
        return w
    from ..parallel.mesh import active_mesh
    mesh = active_mesh()
    kv = w.shape[1] * mesh.coord(cfg.tp_axis) // mesh.sizes[cfg.tp_axis]
    return tp_copy(w, cfg.tp_axis)[:, kv:kv + cfg.n_kv_heads]


def _project_qkv(p, x: torch.Tensor, kv_src: torch.Tensor, cfg: ModelConfig,
                 rope_q: Rope, rope_k: Rope):
    """q from ``x``, k and v from ``kv_src`` (x itself for self-attention),
    (B, S, heads, hd), with qk-norm; RoPE only on a side whose tables are
    given (cross-attention passes none).  Under tensor parallelism the
    products are head-sharded: ``x`` and ``kv_src`` enter through
    ``tp_copy``, and so do the qk-norm scales, shared by every head, so
    that their partial gradients sum over the axis."""
    axis = cfg.tp_axis
    same = kv_src is x
    x = tp_copy(x, axis)
    kv_src = x if same else tp_copy(kv_src, axis)
    q = _heads(x, p["wq"])
    k = _heads(kv_src, _kv_weight(p["wk"], cfg))
    v = _heads(kv_src, _kv_weight(p["wv"], cfg))
    if cfg.qk_norm:
        q = rms_head_norm(tp_copy(p["q_norm"], axis), q, cfg.norm_eps)
        k = rms_head_norm(tp_copy(p["k_norm"], axis), k, cfg.norm_eps)
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


def _attend(q, k, v, q_pos, k_pos, cfg: ModelConfig, causal: bool
            ) -> torch.Tensor:
    """``_attn_core`` over q's rows, in query chunks of ``cfg.attn_chunk``
    when there are more than two of them (the chunks bound the score
    matrix to (B, KV, G, chunk, Sk))."""
    scale = 1.0 / (cfg.hd ** 0.5)
    S, chunk = q.shape[1], cfg.attn_chunk
    if S > 2 * chunk and S % chunk == 0:
        return torch.cat([
            _attn_core(q[:, i:i + chunk], k, v,
                       None if q_pos is None else q_pos[:, i:i + chunk],
                       k_pos, causal=causal, scale=scale,
                       soft_cap=cfg.attn_logit_soft_cap)
            for i in range(0, S, chunk)], dim=1)
    return _attn_core(q, k, v, q_pos, k_pos, causal=causal, scale=scale,
                      soft_cap=cfg.attn_logit_soft_cap)


def _axis_rows(cfg: ModelConfig, S: int) -> Optional[slice]:
    """This rank's block of S rows over ``cfg.tp_axis``, None when the
    axis does not divide S."""
    from ..parallel.mesh import active_mesh
    mesh = active_mesh()
    n = mesh.sizes[cfg.tp_axis]
    if S % n:
        return None
    r = mesh.coord(cfg.tp_axis)
    return slice(r * S // n, (r + 1) * S // n)


def context_rows(cfg: ModelConfig, S: int) -> Optional[slice]:
    """This rank's rows of an S-long sequence under context-parallel
    attention (a ``context_parallel`` layout: query heads that do not
    divide ``cfg.tp_axis``), the reference's ``seq_fb`` claim; None when
    attention runs on every row: no such config, or S does not divide
    the axis (the legalizer then leaves the rows whole, and every rank
    attends all of them)."""
    if cfg.tp_axis is None or not layout_of(cfg).context_parallel:
        return None
    return _axis_rows(cfg, S)


def line_rows(cfg: ModelConfig, S: int, *, latent: bool = False
              ) -> Optional[slice]:
    """This rank's rows of a dense cache's S lines: the rules put
    ``kv_seq`` on ``model`` where the KV heads do not divide it (a
    ``kv_sliced``, ``context_parallel`` or ``kv_seq`` layout; MLA's latent
    lines, ``latent``, always) and S does; None where the rank holds
    every line of its KV heads."""
    lay = layout_of(cfg)
    if cfg.tp_axis is None or not (latent or lay.kv_sliced
                                   or lay.context_parallel or lay.kv_seq):
        return None
    return _axis_rows(cfg, S)


def _rope_rows(rope: Rope, rows: slice) -> Rope:
    """RoPE tables (..., S, hd/2) cut to ``rows`` of S."""
    if rope is None:
        return None
    return rope[0][..., rows, :], rope[1][..., rows, :]


def _block_lines(p, src: torch.Tensor, cfg: ModelConfig, rope: Rope,
                 rows: slice):
    """The cache lines of ``rows`` of ``src`` for every KV head of the
    replicated ``wk`` / ``wv`` (a KV-sliced rank's block of the cache:
    its lines, all heads), k-normed and RoPE'd as attended."""
    xs = src[:, rows]
    k, v = _heads(xs, p["wk"]), _heads(xs, p["wv"])
    if cfg.qk_norm:
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope is not None:
        k = apply_rope(k, *_rope_rows(rope, rows))
    return k, v


def multihead_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                        positions: Optional[torch.Tensor], rope: Rope,
                        kv_src: Optional[torch.Tensor] = None,
                        causal: Optional[bool] = None, lines: bool = False
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (prefill, encoder).  x (B, S, D),
    positions (B, S) or None (``arange``), ``rope`` = rope_tables(cfg,
    positions) or None.  With ``kv_src`` (B, Sk, D) it is cross-attention:
    no RoPE, not causal, and the output scaled by ``tanh(gate)``; else
    causal as ``cfg.causal`` unless ``causal`` says otherwise.  Returns
    (out (B, S, D), {"k", "v"} (B, Sk, KV, hd)) — the K/V lines a prefill
    collects (qk-normed and RoPE'd as attended).  With ``lines`` (a
    prefill collecting them) a tensor-parallel rank returns its block of
    the dense cache (:func:`line_rows`): its rows of the lines where the
    rules cut them, a KV-sliced rank's for every KV head.

    On a ``context_parallel`` layout whose sequence divides the axis
    (:func:`context_rows`) attention runs context parallel: q and o for
    the rank's rows of the sequence, K / V whole, the causal mask offset
    to the rows, and the o-projection of the rank's rows gathered along
    the sequence (``collectives.seq_gather``); under
    ``cfg.tp_attn_inner`` o is gathered instead and the o-projection
    splits the flat H x hd dim over the axis (``_out_proj``'s
    row-parallel product).  The replicated weights a rank reads for its
    rows only, and the activations entering, go through ``tp_copy``.
    Where the sequence does not divide, attention runs whole on every
    rank, without edges."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    cross = kv_src is not None
    src = kv_src if cross else x
    causal = (cfg.causal and not cross) if causal is None else causal
    rope = None if cross else rope
    Sk = src.shape[1]
    q_pos = k_pos = None
    if causal:
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        q_pos = positions
        k_pos = (positions if Sk == S else torch.arange(
            Sk, dtype=torch.int32, device=x.device).expand(B, Sk))
    rows = context_rows(cfg, S)
    if rows is None and layout_of(cfg).context_parallel:
        cfg = dataclasses.replace(cfg, tp_axis=None)    # whole on every rank
    if rows is None:
        q, k, v = _project_qkv(p, x, src, cfg, rope, rope)
        o = _attend(q.reshape(B, S, KV, G, hd), k, v, q_pos, k_pos, cfg,
                    causal)
        out = _out_proj(o, p["wo"], cfg)
    else:
        out, k, v = _context_parallel(p, x, src, cfg, rope, rows, q_pos,
                                      k_pos, causal)
    if cross and "gate" in p:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    if lines:
        lr = line_rows(cfg, Sk)
        if lr is not None:
            k, v = ((k[:, lr], v[:, lr]) if rows is not None
                    else _block_lines(p, src, cfg, rope, lr))
    return out, {"k": k, "v": v}


def _context_parallel(p, x: torch.Tensor, src: torch.Tensor,
                      cfg: ModelConfig, rope: Rope, rows: slice,
                      q_pos, k_pos, causal: bool):
    """:func:`multihead_attention`'s context-parallel body: returns (out
    (B, S, D) gathered, k, v whole)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    axis = cfg.tp_axis
    same = src is x
    x = tp_copy(x, axis)
    src = x if same else tp_copy(src, axis)
    w = {k: tp_copy(v, axis) for k, v in p.items()
         if k in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")}
    q = _heads(seq_slice(x, 1, axis), w["wq"])
    k, v = _heads(src, w["wk"]), _heads(src, w["wv"])
    if cfg.qk_norm:
        q = rms_head_norm(w["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(w["k_norm"], k, cfg.norm_eps)
    if rope is not None:
        q = apply_rope(q, *_rope_rows(rope, rows))
        k = apply_rope(k, *rope)
    n = rows.stop - rows.start
    o = _attend(q.reshape(B, n, KV, H // KV, hd), k, v,
                None if q_pos is None else q_pos[:, rows], k_pos, cfg,
                causal).reshape(B, n, H * hd)
    wo = w["wo"].reshape(H * hd, D)
    cols = _axis_rows(cfg, H * hd)
    if cfg.tp_attn_inner and cols is not None:
        # tp_oproj: o gathered along the sequence, then the flat H x hd
        # dim split over the axis, a row-parallel product
        o = tp_copy(seq_gather(o, 1, axis), axis)
        return (row_parallel_matmul(o[..., cols], wo[cols], axis,
                                    cfg.tp_overlap), k, v)
    return seq_gather(o @ wo, 1, axis), k, v


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


def dense_page(lines: int) -> int:
    """The page a dense cache of ``lines`` lines is viewed in:
    ``DENSE_PAGE``, or the whole row where that does not divide it (a
    rank's block of a cross-attention cache whose source length is no
    multiple of 16)."""
    return DENSE_PAGE if lines % DENSE_PAGE == 0 else lines


def identity_tables(batch: int, lines: int, device) -> torch.Tensor:
    """The block table of a dense cache (batch, lines, ...) viewed as a
    pool of pages of ``dense_page(lines)`` lines: row b's block j is page
    ``b * n_blocks + j``.  (batch, n_blocks) int32."""
    nb = lines // dense_page(lines)
    return torch.arange(batch * nb, dtype=torch.int32,
                        device=device).view(batch, nb)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor, *, scale: float,
                    soft_cap: float = 0.0, return_lse: bool = False):
    """One query token a row against dense caches k/v (B, Smax_r, KV, hd)
    through ``kernels.ops.paged_attention``: the caches viewed, without a
    copy, as a pool (B * Smax_r / page, page, KV, hd) under
    :func:`identity_tables` (page :func:`dense_page`).  q (B, KV, G, hd);
    pos (B,) int32, the last line each row sees (< 0: none).  Returns
    (B, KV, G, hd), and with ``return_lse`` the rows' log-sum-exps (B,
    KV, G) float32 too."""
    B, S, KV, hd = k.shape
    page = dense_page(S)
    shape = (B * S // page, page, KV, hd)
    return kernel_ops.paged_attention(
        q.contiguous(), k.view(shape), v.view(shape),
        identity_tables(B, S, q.device), pos, scale=scale,
        soft_cap=soft_cap, pipeline="off", return_lse=return_lse)


def cut_lines(cfg: ModelConfig) -> bool:
    """Whether a decode rank's dense caches hold its block of the lines
    (a ``kv_seq`` layout under a tp axis)."""
    return cfg.tp_axis is not None and layout_of(cfg).kv_seq


def block_start(cfg: ModelConfig, lines: int) -> int:
    """The first line of this rank's block of ``lines`` lines over
    ``cfg.tp_axis`` (its coordinate times the block)."""
    from ..parallel.mesh import active_mesh
    return active_mesh().coord(cfg.tp_axis) * lines


def write_owned(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                local: torch.Tensor) -> None:
    """Write each row's new line ``new[name]`` (B, ...) at its local
    position ``local`` (B,) of the rank's block ``cache[name]`` (B, L,
    ...), in place, where the rank owns it (0 <= local < L); elsewhere the
    line the clipped index points at is written back unchanged, so the
    shapes never depend on who owns the position."""
    name0 = next(iter(new))
    B, L = cache[name0].shape[:2]
    rows = torch.arange(B, device=local.device)
    idx = local.clamp(0, L - 1).long()
    own = (local >= 0) & (local < L)
    for name, line in new.items():
        c = cache[name]
        keep = own.view((B,) + (1,) * (line.dim() - 1))
        c.index_put_((rows, idx), torch.where(keep, line.to(c.dtype),
                                              c[rows, idx]))


def _merged_out(p, o: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    """A kv_seq rank's attention output o (B, 1, H, hd) over every query
    head, merged over the axis, through the o-projection: the rank's
    heads of it into its block of ``wo`` (a row-parallel product) where
    the query heads are split; where they are whole (``wo`` replicated)
    the whole product, or under ``cfg.tp_attn_inner`` the rank's columns
    of the flat H x hd dim (row parallel)."""
    B, _, H, hd = o.shape
    o = o.to(dtype)
    if not layout_of(cfg).context_parallel:
        first = block_start(cfg, cfg.n_heads)
        return _out_proj(o[:, :, first:first + cfg.n_heads], p["wo"], cfg)
    wo = p["wo"].reshape(H * hd, -1)
    flat = o.reshape(B, 1, H * hd)
    cols = _axis_rows(cfg, H * hd)
    if cfg.tp_attn_inner and cols is not None:
        return row_parallel_matmul(flat[..., cols], wo[cols], cfg.tp_axis,
                                   cfg.tp_overlap)
    return flat @ wo


def _all_heads(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A kv_seq rank's queries (B, 1, heads, hd) of every head: its own
    gathered over the axis where the query heads are split."""
    if layout_of(cfg).context_parallel:
        return q
    return head_gather(q, 2, cfg.tp_axis)


def _decode_cut(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: torch.Tensor, cfg: ModelConfig, rope: Rope
                ) -> torch.Tensor:
    """:func:`decode_attention` on a rank's block of the lines."""
    B = x.shape[0]
    KV, hd = cfg.n_kv_heads, cfg.hd
    q, k_new, v_new = _project_qkv(p, x, x, cfg, rope, rope)
    L = cache["k"].shape[1]
    local = pos - block_start(cfg, L)
    write_owned(cache, {"k": k_new[:, 0], "v": v_new[:, 0]}, local)
    q = _all_heads(q, cfg)
    H = q.shape[2]
    with named_scope("paged_attention"):
        o, lse = dense_attention(
            q.reshape(B, KV, H // KV, hd), cache["k"], cache["v"],
            local.clamp(max=L - 1), scale=1.0 / (hd ** 0.5),
            soft_cap=cfg.attn_logit_soft_cap, return_lse=True)
    o = kv_merge(o, lse, cfg.tp_axis).reshape(B, 1, H, hd)
    return _merged_out(p, o, cfg, x.dtype)


def cross_decode(p, q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 cfg: ModelConfig, src_len: int, dtype) -> torch.Tensor:
    """A kv_seq rank's cross-attention decode (ungated): q (B, 1, heads,
    hd) its query heads (q-normed), ck / cv (B, L, KV, hd) its cache of
    the ``src_len`` source lines: its block of them where the axis
    divides ``src_len`` (the cut ``line_rows`` makes at prefill), merged
    over the axis, else every line (the rules leave them whole), attended
    whole.  Returns (B, 1, D) in ``dtype``."""
    B, _, _, hd = q.shape
    KV = cfg.n_kv_heads
    q = _all_heads(q, cfg)
    H = q.shape[2]
    L = ck.shape[1]
    cut = _axis_rows(cfg, src_len) is not None
    last = src_len - 1 - (block_start(cfg, L) if cut else 0)
    lim = torch.full((B,), min(last, L - 1), dtype=torch.int32,
                     device=q.device)
    q = q.reshape(B, KV, H // KV, hd)
    with named_scope("paged_attention"):
        if cut:
            o, lse = dense_attention(q, ck, cv, lim, scale=1.0 / (hd ** 0.5),
                                     return_lse=True)
            o = kv_merge(o, lse, cfg.tp_axis)
        else:
            o = dense_attention(q, ck, cv, lim, scale=1.0 / (hd ** 0.5))
    return _merged_out(p, o.reshape(B, 1, H, hd), cfg, dtype)


def decode_attention(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: torch.Tensor, cfg: ModelConfig, *, rope: Rope
                     ) -> torch.Tensor:
    """One-token decode against a dense cache (updated in place).
    x (B,1,D); cache k/v (B, Smax_r, KV, hd); pos (B,) int32, the write
    position of each row (the reference's scalar, broadcast); ``rope`` =
    rope_tables(cfg, pos[:, None]).  On cut lines (:func:`cut_lines`) the
    cache is the rank's block of the lines, every KV head, and the
    attention is merged over the axis (the module docstring)."""
    if cut_lines(cfg):
        return _decode_cut(p, x, cache, pos, cfg, rope)
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
