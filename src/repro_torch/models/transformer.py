"""Block assembly and the decoder: segments of stacked superblocks walked
by a Python loop (the reference walks them with ``jax.lax.scan``).

Parameters and page pools keep the reference's layout — one list entry
per ``cfg.segments()`` piece, every leaf stacked ``(reps, ...)`` — so a
weight tree crosses from the JAX package leaf for leaf; layer ``i`` of a
segment is the ``[i]`` view of each stacked leaf.

This covers decoder-only archs built of GQA attention or MLA blocks with a
dense, MoE or no FFN; every other block kind raises NotImplementedError
naming its ROADMAP item.  RoPE tables are computed once per forward for
each mixer kind present (:func:`rope_tables`) and handed to every layer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from .common import BlockDef, ModelConfig
from .layers import (apply_mlp, apply_norm, embed_defs, embed_tokens,
                     logits_from_hidden, mlp_defs, norm_defs)
from .params import stack_defs, tree_map

# a prefill chunk's first position: a host int, or a 0-d int32 device
# tensor (the captured chunk's persistent input)
Offset = Union[int, torch.Tensor]

# ROADMAP queue 1 item that ports each block kind still missing
_TODO = {"mamba": 8, "mlstm": 8, "slstm": 8,
         "cross_attn": 9, "attn+cross": 9}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for configs this slice does not port."""
    if cfg.is_encoder_decoder or cfg.n_image_tokens:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder / vision models are not ported "
            "yet: ROADMAP queue 1 item 9")
    for unit, _ in cfg.segments():
        for b in unit:
            for kind in (b.mixer, b.ffn):
                if kind in _TODO:
                    raise NotImplementedError(
                        f"{cfg.name}: {kind!r} blocks are not ported yet: "
                        f"ROADMAP queue 1 item {_TODO[kind]}")
    if cfg.tp_axis is not None:
        raise NotImplementedError("tensor parallelism is not ported yet: "
                                  "ROADMAP queue 1 item 11")


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked ``(reps, ...)`` dict tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# Defs
# --------------------------------------------------------------------------

def block_defs(cfg: ModelConfig, b: BlockDef) -> Dict[str, Any]:
    defs: Dict[str, Any] = {"norm1": norm_defs(cfg)}
    if b.mixer == "attn":
        defs["mixer"] = attn.attn_defs(cfg)
    else:
        defs["mixer"] = mla_mod.mla_defs(cfg)
    if b.ffn == "dense":
        defs["norm2"] = norm_defs(cfg)
        defs["ffn"] = mlp_defs(cfg)
    elif b.ffn == "moe":
        defs["norm2"] = norm_defs(cfg)
        defs["ffn"] = moe_mod.moe_defs(cfg)
    return defs


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    segs = []
    for unit, reps in cfg.segments():
        unit_defs = {f"b{i}": block_defs(cfg, b) for i, b in enumerate(unit)}
        segs.append(stack_defs(unit_defs, reps))
    return {"embed": embed_defs(cfg), "segments": segs,
            "final_norm": norm_defs(cfg)}


def paged_cache_defs(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int) -> List[Dict[str, Any]]:
    """Per-segment page pools: (reps, num_pages, page_size, KV, hd) K/V
    for GQA blocks, (reps, num_pages, page_size, r | dr) latent and rope
    lines for MLA blocks.  ``num_slots`` sizes recurrent state rows,
    which no ported block has; it stays for the reference's signature."""
    check_supported(cfg)
    segs = []
    for unit, reps in cfg.segments():
        unit_caches = {
            f"b{i}": (attn.paged_pool_defs(cfg, num_pages, page_size)
                      if b.mixer == "attn" else
                      mla_mod.mla_paged_pool_defs(cfg, num_pages, page_size))
            for i, b in enumerate(unit)}
        segs.append(stack_defs(unit_caches, reps))
    return segs


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Dict[str, attn.Rope]:
    """RoPE cos/sin per mixer kind in the model (GQA at ``hd``, MLA at
    ``rope_head_dim``), computed once per forward for ``positions``."""
    kinds = {b.mixer for unit, _ in cfg.segments() for b in unit}
    ropes: Dict[str, attn.Rope] = {}
    if "attn" in kinds:
        ropes["attn"] = attn.rope_tables(cfg, positions)
    if "mla" in kinds:
        ropes["mla"] = mla_mod.rope_tables(cfg, positions)
    return ropes


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _ffn_tail(p, b: BlockDef, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """Shared norm2 -> FFN -> residual tail (the MoE aux loss, a training
    term, is dropped)."""
    if b.ffn == "none":
        return x
    h = apply_norm(p["norm2"], x, cfg)
    if b.ffn == "dense":
        o = apply_mlp(p["ffn"], h, cfg)
    else:
        o, _ = moe_mod.moe_ffn(p["ffn"], h, cfg)
    return x + cfg.residual_scale * o


def apply_block_full(p, b: BlockDef, x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor, ropes: Dict[str, attn.Rope]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x, state) — the block's cache lines: {"k", "v"} for GQA,
    {"c_kv", "k_rope"} for MLA."""
    h = apply_norm(p["norm1"], x, cfg)
    if b.mixer == "attn":
        o, state = attn.multihead_attention(p["mixer"], h, cfg,
                                            positions=positions,
                                            rope=ropes["attn"])
    else:
        o, state = mla_mod.mla_attention(p["mixer"], h, cfg, positions,
                                         rope=ropes["mla"])
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg), state


def apply_block_decode(p, b: BlockDef, x: torch.Tensor,
                       pool: Dict[str, torch.Tensor], pos: torch.Tensor,
                       cfg: ModelConfig, block_tables: torch.Tensor,
                       page_size: int, ropes: Dict[str, attn.Rope],
                       pipeline: Optional[str] = None) -> torch.Tensor:
    """One-token paged decode through a block (pool updated in place);
    ``pipeline`` is the attention kernel's page-streaming schedule."""
    h = apply_norm(p["norm1"], x, cfg)
    if b.mixer == "attn":
        o = attn.decode_attention_paged(p["mixer"], h, pool, block_tables,
                                        pos, cfg, page_size=page_size,
                                        rope=ropes["attn"], pipeline=pipeline)
    else:
        o = mla_mod.mla_decode_paged(p["mixer"], h, pool, block_tables, pos,
                                     cfg, page_size=page_size,
                                     rope=ropes["mla"], pipeline=pipeline)
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg)


def apply_block_verify(p, b: BlockDef, x: torch.Tensor,
                       pool: Dict[str, torch.Tensor], pos: torch.Tensor,
                       cfg: ModelConfig, block_tables: torch.Tensor,
                       page_size: int, ropes: Dict[str, attn.Rope],
                       pipeline: Optional[str] = None) -> torch.Tensor:
    """Multi-token verification through one block (speculative decoding),
    pool updated in place.  x (B, T, D) draft-chain tokens at per-slot
    positions ``pos + t``.  Attention-family mixers only: a recurrent
    mixer's state advance cannot be rolled back when drafts are rejected
    (serve.spec.supports_spec)."""
    h = apply_norm(p["norm1"], x, cfg)
    if b.mixer == "attn":
        o = attn.decode_verify_paged(p["mixer"], h, pool, block_tables, pos,
                                     cfg, page_size=page_size,
                                     rope=ropes["attn"], pipeline=pipeline)
    elif b.mixer == "mla":
        o = mla_mod.mla_decode_verify_paged(p["mixer"], h, pool,
                                            block_tables, pos, cfg,
                                            page_size=page_size,
                                            rope=ropes["mla"],
                                            pipeline=pipeline)
    else:
        raise NotImplementedError(
            f"speculative verification needs a rollback-free cache; mixer "
            f"{b.mixer!r} carries recurrent state (attn/mla only)")
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg)


def apply_block_prefill_chunk(p, b: BlockDef, x: torch.Tensor,
                              pool: Dict[str, torch.Tensor], offset: Offset,
                              block_table: torch.Tensor, cfg: ModelConfig,
                              page_size: int, ropes: Dict[str, attn.Rope]
                              ) -> torch.Tensor:
    """Prefill one chunk of ONE request through a block (pool updated in
    place).  x (1,T,D) at positions offset..offset+T-1 (``offset`` an int
    or a 0-d int32 device tensor)."""
    h = apply_norm(p["norm1"], x, cfg)
    if b.mixer == "attn":
        o = attn.prefill_attention_paged(p["mixer"], h, pool, block_table,
                                         offset, cfg, page_size=page_size,
                                         rope=ropes["attn"])
    else:
        o = mla_mod.mla_prefill_paged(p["mixer"], h, pool, block_table,
                                      offset, cfg, page_size=page_size,
                                      rope=ropes["mla"])
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg)


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def forward_full(params, cfg: ModelConfig, tokens: torch.Tensor,
                 collect_state: bool = False):
    """Full-sequence causal forward.  tokens (B, S) int.  Returns
    (logits (B, S, V), states) — states (with ``collect_state``) per
    segment ``{"b<i>": lines}`` stacked (reps, B, S, ...), else None."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    ropes = rope_tables(cfg, positions)
    states: List[Any] = []
    for seg_params, (unit, reps) in zip(params["segments"], cfg.segments()):
        per_layer = []
        for r in range(reps):
            layer_p = _layer(seg_params, r)
            st = {}
            for i, b in enumerate(unit):
                x, st[f"b{i}"] = apply_block_full(layer_p[f"b{i}"], b, x,
                                                  cfg, positions, ropes)
            per_layer.append(st)
        if collect_state:
            states.append(tree_map(lambda *xs: torch.stack(xs),
                                   *per_layer))
    x = apply_norm(params["final_norm"], x, cfg)
    logits = logits_from_hidden(params["embed"], x, cfg)
    return logits, (states if collect_state else None)


def decode_one_paged(params, cfg: ModelConfig, pools: List[Any],
                     block_tables: torch.Tensor, token: torch.Tensor,
                     pos: torch.Tensor, *, page_size: int,
                     pipeline: Optional[str] = None) -> torch.Tensor:
    """One decode step over the packed slot batch.

    token (B,1) (B = num_slots); pos (B,) int32 per-slot positions;
    block_tables (B, n_blocks) int32.  Idle lanes point at the trash page
    and compute garbage the engine discards.  The pools are updated in
    place; returns logits (B, V).  Shapes do not depend on which slots
    are live.  ``pipeline`` selects the paged-attention kernels'
    page-streaming schedule (kernels/ops.py; None = process default)."""
    x = embed_tokens(params["embed"], token, cfg, pos[:, None])
    ropes = rope_tables(cfg, pos[:, None])
    for seg_params, seg_pool, (unit, reps) in zip(
            params["segments"], pools, cfg.segments()):
        for r in range(reps):
            layer_p, layer_c = _layer(seg_params, r), _layer(seg_pool, r)
            for i, b in enumerate(unit):
                x = apply_block_decode(layer_p[f"b{i}"], b, x,
                                       layer_c[f"b{i}"], pos, cfg,
                                       block_tables, page_size, ropes,
                                       pipeline)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params["embed"], x, cfg)[:, 0, :]


def decode_verify_paged(params, cfg: ModelConfig, pools: List[Any],
                        block_tables: torch.Tensor, tokens: torch.Tensor,
                        pos: torch.Tensor, *, page_size: int,
                        pipeline: Optional[str] = None) -> torch.Tensor:
    """Score T = k+1 draft-chain tokens per slot in ONE weight pass.

    tokens (B, T): per slot [last committed token, draft_1..draft_k]; pos
    (B,) int32 the first token's position (= context_len - 1);
    block_tables (B, n_blocks) int32.  Returns logits (B, T, V):
    logits[:, t] is the distribution after token t, what one sequential
    decode step would give.  All T K/V lines are written in place;
    rejected positions are overwritten when the real token is later fed
    there.  The weights and each slot's page walk are read once for the T
    tokens.  ``pipeline`` as in :func:`decode_one_paged`."""
    T = tokens.shape[1]
    posq = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                       device=tokens.device)[None, :]
    x = embed_tokens(params["embed"], tokens, cfg, posq)
    ropes = rope_tables(cfg, posq)
    for seg_params, seg_pool, (unit, reps) in zip(
            params["segments"], pools, cfg.segments()):
        for r in range(reps):
            layer_p, layer_c = _layer(seg_params, r), _layer(seg_pool, r)
            for i, b in enumerate(unit):
                x = apply_block_verify(layer_p[f"b{i}"], b, x,
                                       layer_c[f"b{i}"], pos, cfg,
                                       block_tables, page_size, ropes,
                                       pipeline)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params["embed"], x, cfg)


def prefill_chunk_paged(params, cfg: ModelConfig, pools: List[Any],
                        block_table: torch.Tensor, tokens: torch.Tensor,
                        offset: Offset, *, page_size: int) -> torch.Tensor:
    """Prefill one chunk of one request into its pages (updated in place).

    tokens (1,T) at positions offset..offset+T-1; block_table (n_blocks,)
    for this request's slot.  ``offset`` is an int or a 0-d int32 tensor
    on the tokens' device: nothing here reads it on the host, so a
    captured chunk replays at any offset, and its shapes depend on T and
    n_blocks alone (the attention walks the whole table row).  Returns
    last-token logits (1, V).  Repeated calls over consecutive chunks
    equal one whole-prompt prefill (for dense FFNs; an MoE FFN's capacity
    depends on the tokens per call)."""
    T = tokens.shape[1]
    positions = offset + torch.arange(T, dtype=torch.int32,
                                      device=tokens.device)[None, :]
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    ropes = rope_tables(cfg, positions)
    for seg_params, seg_pool, (unit, reps) in zip(
            params["segments"], pools, cfg.segments()):
        for r in range(reps):
            layer_p, layer_c = _layer(seg_params, r), _layer(seg_pool, r)
            for i, b in enumerate(unit):
                x = apply_block_prefill_chunk(layer_p[f"b{i}"], b, x,
                                              layer_c[f"b{i}"], offset,
                                              block_table, cfg, page_size,
                                              ropes)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params["embed"], x[:, -1:], cfg)[:, 0, :]
