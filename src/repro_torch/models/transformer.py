"""Block assembly and the decoder: segments of stacked superblocks walked
by a Python loop (the reference walks them with ``jax.lax.scan``).

Parameters and page pools keep the reference's layout — one list entry
per ``cfg.segments()`` piece, every leaf stacked ``(reps, ...)`` — so a
weight tree crosses from the JAX package leaf for leaf; layer ``i`` of a
segment is the ``[i]`` view of each stacked leaf.

This slice covers decoder-only archs built of GQA attention blocks with a
dense (or no) FFN; every other block kind raises NotImplementedError
naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import attention as attn
from .common import BlockDef, ModelConfig
from .layers import (apply_mlp, apply_norm, embed_defs, embed_tokens,
                     logits_from_hidden, mlp_defs, norm_defs)
from .params import stack_defs, tree_map

# ROADMAP queue 1 item that ports each block kind still missing
_TODO = {"mla": 6, "moe": 6, "mamba": 8, "mlstm": 8, "slstm": 8,
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
    defs: Dict[str, Any] = {"norm1": norm_defs(cfg),
                            "mixer": attn.attn_defs(cfg)}
    if b.ffn == "dense":
        defs["norm2"] = norm_defs(cfg)
        defs["ffn"] = mlp_defs(cfg)
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
    """Per-segment page pools (reps, num_pages, page_size, KV, hd).
    ``num_slots`` sizes recurrent state rows, which this slice has none
    of; it stays for the reference's signature."""
    check_supported(cfg)
    segs = []
    for unit, reps in cfg.segments():
        unit_caches = {f"b{i}": attn.paged_pool_defs(cfg, num_pages,
                                                     page_size)
                       for i in range(len(unit))}
        segs.append(stack_defs(unit_caches, reps))
    return segs


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _ffn_tail(p, b: BlockDef, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """Shared norm2 -> FFN -> residual tail."""
    if b.ffn == "none":
        return x
    h = apply_norm(p["norm2"], x, cfg)
    return x + cfg.residual_scale * apply_mlp(p["ffn"], h, cfg)


def apply_block_full(p, b: BlockDef, x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor, rope: attn.Rope
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x, {"k", "v"}) — the block's K/V lines for the cache."""
    h = apply_norm(p["norm1"], x, cfg)
    o, state = attn.multihead_attention(p["mixer"], h, cfg,
                                        positions=positions, rope=rope)
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg), state


def apply_block_decode(p, b: BlockDef, x: torch.Tensor,
                       pool: Dict[str, torch.Tensor], pos: torch.Tensor,
                       cfg: ModelConfig, block_tables: torch.Tensor,
                       page_size: int, rope: attn.Rope) -> torch.Tensor:
    """One-token paged decode through a block (pool updated in place)."""
    h = apply_norm(p["norm1"], x, cfg)
    o = attn.decode_attention_paged(p["mixer"], h, pool, block_tables, pos,
                                    cfg, page_size=page_size, rope=rope)
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg)


def apply_block_prefill_chunk(p, b: BlockDef, x: torch.Tensor,
                              pool: Dict[str, torch.Tensor], offset: int,
                              block_table: torch.Tensor, cfg: ModelConfig,
                              page_size: int, rope: attn.Rope
                              ) -> torch.Tensor:
    """Prefill one chunk of ONE request through a block (pool updated in
    place).  x (1,T,D) at positions offset..offset+T-1."""
    h = apply_norm(p["norm1"], x, cfg)
    o = attn.prefill_attention_paged(p["mixer"], h, pool, block_table,
                                     offset, cfg, page_size=page_size,
                                     rope=rope)
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg)


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def forward_full(params, cfg: ModelConfig, tokens: torch.Tensor,
                 collect_state: bool = False):
    """Full-sequence causal forward.  tokens (B, S) int.  Returns
    (logits (B, S, V), states) — states (with ``collect_state``) per
    segment ``{"b<i>": {"k", "v"}}`` stacked (reps, B, S, KV, hd), else
    None."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    rope = attn.rope_tables(cfg, positions)
    states: List[Any] = []
    for seg_params, (unit, reps) in zip(params["segments"], cfg.segments()):
        per_layer = []
        for r in range(reps):
            layer_p = _layer(seg_params, r)
            st = {}
            for i, b in enumerate(unit):
                x, st[f"b{i}"] = apply_block_full(layer_p[f"b{i}"], b, x,
                                                  cfg, positions, rope)
            per_layer.append(st)
        if collect_state:
            states.append(tree_map(lambda *xs: torch.stack(xs),
                                   *per_layer))
    x = apply_norm(params["final_norm"], x, cfg)
    logits = logits_from_hidden(params["embed"], x, cfg)
    return logits, (states if collect_state else None)


def decode_one_paged(params, cfg: ModelConfig, pools: List[Any],
                     block_tables: torch.Tensor, token: torch.Tensor,
                     pos: torch.Tensor, *, page_size: int) -> torch.Tensor:
    """One decode step over the packed slot batch.

    token (B,1) (B = num_slots); pos (B,) int32 per-slot positions;
    block_tables (B, n_blocks) int32.  Idle lanes point at the trash page
    and compute garbage the engine discards.  The pools are updated in
    place; returns logits (B, V).  Shapes do not depend on which slots
    are live."""
    x = embed_tokens(params["embed"], token, cfg, pos[:, None])
    rope = attn.rope_tables(cfg, pos[:, None])
    for seg_params, seg_pool, (unit, reps) in zip(
            params["segments"], pools, cfg.segments()):
        for r in range(reps):
            layer_p, layer_c = _layer(seg_params, r), _layer(seg_pool, r)
            for i, b in enumerate(unit):
                x = apply_block_decode(layer_p[f"b{i}"], b, x,
                                       layer_c[f"b{i}"], pos, cfg,
                                       block_tables, page_size, rope)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params["embed"], x, cfg)[:, 0, :]


def prefill_chunk_paged(params, cfg: ModelConfig, pools: List[Any],
                        block_table: torch.Tensor, tokens: torch.Tensor,
                        offset: int, *, page_size: int) -> torch.Tensor:
    """Prefill one chunk of one request into its pages (updated in place).

    tokens (1,T) at positions offset..offset+T-1; block_table (n_blocks,)
    for this request's slot.  Returns last-token logits (1, V).  Repeated
    calls over consecutive chunks equal one whole-prompt prefill."""
    T = tokens.shape[1]
    positions = offset + torch.arange(T, dtype=torch.int32,
                                      device=tokens.device)[None, :]
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    rope = attn.rope_tables(cfg, positions)
    for seg_params, seg_pool, (unit, reps) in zip(
            params["segments"], pools, cfg.segments()):
        for r in range(reps):
            layer_p, layer_c = _layer(seg_params, r), _layer(seg_pool, r)
            for i, b in enumerate(unit):
                x = apply_block_prefill_chunk(layer_p[f"b{i}"], b, x,
                                              layer_c[f"b{i}"], offset,
                                              block_table, cfg, page_size,
                                              rope)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params["embed"], x[:, -1:], cfg)[:, 0, :]
