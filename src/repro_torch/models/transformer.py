"""Block assembly and the decoder: segments of stacked superblocks walked
by a Python loop (the reference walks them with ``jax.lax.scan``).

Parameters and page pools keep the reference's layout — one list entry
per ``cfg.segments()`` piece, every leaf stacked ``(reps, ...)`` — so a
weight tree crosses from the JAX package leaf for leaf; layer ``i`` of a
segment is the ``[i]`` view of each stacked leaf.

Blocks are GQA attention, MLA, mamba, mLSTM or sLSTM, gated cross
attention (``cross_attn``, llama-3.2-vision) or self + cross attention
(``attn+cross``, whisper's decoder), with a dense, MoE or no FFN; an
encoder-decoder model (whisper) has an ``encoder`` stack of causal GQA
blocks over stub frame embeddings.  The paged engine's caches are page
pools; a recurrent mixer keeps per-slot state rows ``(reps, num_slots,
...)`` beside them, which a decode step freezes for inactive slots and a
prefill chunk reads and writes at its slot.  The static engine's caches
(:func:`cache_defs`, :func:`decode_one`) are dense ``(reps, B, Smax_r,
...)`` buffers, their sequence axis rounded up to a multiple of 16 and
read by the paged-attention kernel through an identity table
(``attention.dense_attention``); cross-attention caches hold the
source's K/V lines, written once by the prefill.
RoPE tables are computed once per forward for each mixer kind present
(:func:`rope_tables`) and handed to every layer.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.roofline.op_cost import named_scope
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .common import BlockDef, ModelConfig
from .layers import (apply_mlp, apply_norm, embed_defs, embed_tokens,
                     logits_from_hidden, mlp_defs, norm_defs, rms_head_norm)
from .params import ParamDef, stack_defs, tree_map

# a prefill chunk's first position (or its slot): a host int, or a 0-d
# int32 device tensor (the captured chunk's persistent input)
Offset = Union[int, torch.Tensor]

# ROADMAP queue 1 item that ports each block kind still missing
_TODO: Dict[str, int] = {}

RECURRENT_MIXERS = ("mamba", "mlstm", "slstm")
# the encoder's blocks (whisper): causal GQA attention and a dense FFN
ENCODER_BLOCK = BlockDef("attn", "dense")


def check_supported(cfg: ModelConfig, train_tp: int = 1) -> None:
    """Raise NotImplementedError for configs this slice does not port;
    with ``train_tp`` > 1 (a train step over a ``model`` axis that wide)
    also for recurrent mixers, whose ``d_ff`` / ``heads`` the
    reference's GSPMD shards in training but the port's explicit edges
    do not yet (ROADMAP queue 1 item 21; serving refuses them at tp > 1
    in both packages)."""
    rec = sorted({b.mixer for b in cfg.block_pattern
                  if b.mixer in RECURRENT_MIXERS})
    if train_tp > 1 and rec:
        raise NotImplementedError(
            f"{cfg.name}: recurrent mixers {rec} have no tensor-parallel "
            f"edges in training (model={train_tp}): ROADMAP queue 1 "
            "item 21")
    for unit, _ in cfg.segments():
        for b in unit:
            for kind in (b.mixer, b.ffn):
                if kind in _TODO:
                    raise NotImplementedError(
                        f"{cfg.name}: {kind!r} blocks are not ported yet: "
                        f"ROADMAP queue 1 item {_TODO[kind]}")


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
    elif b.mixer == "cross_attn":
        defs["mixer"] = attn.attn_defs(cfg, cross=True)
    elif b.mixer == "attn+cross":
        defs["mixer"] = attn.attn_defs(cfg)
        defs["norm_x"] = norm_defs(cfg)
        defs["cross"] = attn.attn_defs(cfg, cross=True)
    elif b.mixer == "mla":
        defs["mixer"] = mla_mod.mla_defs(cfg)
    elif b.mixer == "mamba":
        defs["mixer"] = ssm_mod.mamba_defs(cfg)
    elif b.mixer == "mlstm":
        defs["mixer"] = xlstm_mod.mlstm_defs(cfg)
    elif b.mixer == "slstm":
        defs["mixer"] = xlstm_mod.slstm_defs(cfg)
    else:
        raise ValueError(b.mixer)
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
    defs = {"embed": embed_defs(cfg), "segments": segs,
            "final_norm": norm_defs(cfg)}
    if cfg.is_encoder_decoder:
        enc_unit = {"b0": block_defs(cfg, ENCODER_BLOCK)}
        defs["encoder"] = {
            "blocks": stack_defs(enc_unit, cfg.n_encoder_layers),
            "final_norm": norm_defs(cfg),
            "pos": ParamDef((cfg.n_audio_frames, cfg.d_model), "float32",
                            init="embed", scale=0.02,
                            logical=("seq", "d_model")),
        }
    return defs


def cross_len(cfg: ModelConfig, b: BlockDef) -> int:
    """Source lines of a cross-attention block's cache: the image tokens
    (or audio frames) of ``cross_attn``, the audio frames of
    ``attn+cross``."""
    if b.mixer == "cross_attn":
        return cfg.n_image_tokens or cfg.n_audio_frames
    return cfg.n_audio_frames


def block_cache_defs(cfg: ModelConfig, b: BlockDef, batch: int,
                     max_len: int) -> Dict[str, Any]:
    """One block's dense decode cache ({} if stateless): k/v (batch,
    Smax_r, KV, hd) for self-attention, ck/cv (batch, S_src rounded, KV,
    hd) for cross-attention, the latent lines for MLA, a recurrent
    mixer's state (batch, ...)."""
    if b.mixer == "attn":
        return attn.init_cache_defs(cfg, batch, max_len)
    if b.mixer == "cross_attn":
        c = attn.init_cache_defs(cfg, batch, cross_len(cfg, b))
        return {"ck": c["k"], "cv": c["v"]}
    if b.mixer == "attn+cross":
        c = attn.init_cache_defs(cfg, batch, max_len)
        cc = attn.init_cache_defs(cfg, batch, cross_len(cfg, b))
        return {"k": c["k"], "v": c["v"], "ck": cc["k"], "cv": cc["v"]}
    if b.mixer == "mla":
        return mla_mod.mla_cache_defs(cfg, batch, max_len)
    if b.mixer == "mamba":
        return ssm_mod.state_defs(cfg, batch)
    if b.mixer == "mlstm":
        return xlstm_mod.mlstm_state_defs(cfg, batch)
    if b.mixer == "slstm":
        return xlstm_mod.slstm_state_defs(cfg, batch)
    raise ValueError(b.mixer)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int
               ) -> List[Dict[str, Any]]:
    """Per-segment dense decode caches of the static engine, every leaf
    stacked (reps, ...), zeros."""
    check_supported(cfg)
    segs = []
    for unit, reps in cfg.segments():
        unit_caches = {f"b{i}": block_cache_defs(cfg, b, batch, max_len)
                       for i, b in enumerate(unit)}
        segs.append(stack_defs(unit_caches, reps))
    return segs


def paged_block_cache_defs(cfg: ModelConfig, b: BlockDef, num_slots: int,
                           num_pages: int, page_size: int) -> Dict[str, Any]:
    """One block's decode cache: batchless page pools (num_pages,
    page_size, ...) for GQA / MLA, per-slot state rows (num_slots, ...)
    for a recurrent mixer."""
    if b.mixer == "attn":
        return attn.paged_pool_defs(cfg, num_pages, page_size)
    if b.mixer == "mla":
        return mla_mod.mla_paged_pool_defs(cfg, num_pages, page_size)
    if b.mixer == "mamba":
        return ssm_mod.state_defs(cfg, num_slots)
    if b.mixer == "mlstm":
        return xlstm_mod.mlstm_state_defs(cfg, num_slots)
    if b.mixer == "slstm":
        return xlstm_mod.slstm_state_defs(cfg, num_slots)
    raise NotImplementedError(
        f"paged cache unsupported for mixer {b.mixer!r} (decoder-only)")


def paged_cache_defs(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int) -> List[Dict[str, Any]]:
    """Per-segment decode caches, every leaf stacked (reps, ...): page
    pools (num_pages, page_size, KV, hd) K/V for GQA blocks, (num_pages,
    page_size, r | dr) latent and rope lines for MLA blocks, and state
    rows (num_slots, ...) for recurrent blocks, zeros."""
    check_supported(cfg)
    segs = []
    for unit, reps in cfg.segments():
        unit_caches = {
            f"b{i}": paged_block_cache_defs(cfg, b, num_slots, num_pages,
                                            page_size)
            for i, b in enumerate(unit)}
        segs.append(stack_defs(unit_caches, reps))
    return segs


def has_recurrent(cfg: ModelConfig) -> bool:
    return any(b.mixer in RECURRENT_MIXERS for b in cfg.block_pattern)


def _recurrent_mixer(p, b: BlockDef, h: torch.Tensor, cfg: ModelConfig,
                     state: Optional[Dict[str, torch.Tensor]]):
    """A recurrent mixer over h (B, L, D) from ``state`` (None: zeros).
    Returns (out, new state)."""
    if b.mixer == "mamba":
        return ssm_mod.mamba_mixer(p, h, cfg, state=state, return_state=True)
    if b.mixer == "mlstm":
        return xlstm_mod.mlstm_mixer(p, h, cfg, state=state,
                                     return_state=True)
    return xlstm_mod.slstm_mixer(p, h, cfg, state=state, return_state=True)


def _freeze(rows: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
            active: torch.Tensor) -> None:
    """Write ``new`` into the state rows of the active slots, in place;
    an inactive slot's rows keep their bytes (``torch.where`` into the
    persistent row, so a captured step keeps its pointer)."""
    for name, old in rows.items():
        m = active.reshape((-1,) + (1,) * (old.dim() - 1))
        torch.where(m, new[name].to(old.dtype), old, out=old)


def _slot_index(slot: Offset, device: torch.device) -> torch.Tensor:
    """``slot`` (an int or a 0-d device tensor) as a (1,) long index."""
    if isinstance(slot, torch.Tensor):
        return slot.reshape(1).long()
    return torch.tensor([int(slot)], dtype=torch.long, device=device)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Dict[str, attn.Rope]:
    """RoPE cos/sin per mixer kind in the model (GQA self-attention at
    ``hd``, MLA at ``rope_head_dim``; cross attention takes none),
    computed once per forward for ``positions``."""
    kinds = {b.mixer for unit, _ in cfg.segments() for b in unit}
    ropes: Dict[str, attn.Rope] = {}
    if kinds & {"attn", "attn+cross"}:
        ropes["attn"] = attn.rope_tables(cfg, positions)
    if "mla" in kinds:
        ropes["mla"] = mla_mod.rope_tables(cfg, positions)
    return ropes


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _ffn_tail(p, b: BlockDef, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shared norm2 -> FFN -> residual tail.  Returns (x, aux): the MoE
    FFN's float32 load-balance loss, None for a dense or absent FFN (the
    reference's zero)."""
    if b.ffn == "none":
        return x, None
    h = apply_norm(p["norm2"], x, cfg)
    aux = None
    if b.ffn == "dense":
        o = apply_mlp(p["ffn"], h, cfg)
    else:
        o, aux = moe_mod.moe_ffn(p["ffn"], h, cfg)
    return x + cfg.residual_scale * o, aux


def _cross_kv(p, src: torch.Tensor, cfg: ModelConfig):
    """A cross-attention block's cache lines from the source (B, S_src,
    D): k, v (B, S_src, KV, hd), un-normed (the reference's ``_cross_kv``:
    k_norm is not applied to the cached keys even with ``cfg.qk_norm``,
    though the full forward's cross attention applies it)."""
    return attn._heads(src, p["wk"]), attn._heads(src, p["wv"])


def _cross_attend(p, h: torch.Tensor, src: torch.Tensor, cfg: ModelConfig,
                  lines: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence gated cross attention of h over ``src`` and the
    lines a prefill collects for it ({"ck", "cv"}, :func:`_cross_kv`;
    with ``lines`` a tensor-parallel rank's block of them,
    ``attention.multihead_attention``'s)."""
    o, kv = attn.multihead_attention(p, h, cfg, positions=None, rope=None,
                                     kv_src=src, causal=False, lines=lines)
    if not cfg.qk_norm:
        return o, {"ck": kv["k"], "cv": kv["v"]}
    rows = attn.line_rows(cfg, src.shape[1]) if lines else None
    return o, dict(zip(("ck", "cv"), _cross_kv(
        p, src if rows is None else src[:, rows], cfg)))


def apply_block_full(p, b: BlockDef, x: torch.Tensor, cfg: ModelConfig,
                     positions: Optional[torch.Tensor],
                     ropes: Dict[str, attn.Rope],
                     cross_src: Optional[torch.Tensor] = None,
                     lines: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """Returns (x, aux, state): the MoE aux loss (None without a MoE
    FFN) and the block's cache lines: {"k", "v"} for GQA, {"ck", "cv"}
    over ``cross_src`` (B, S_src, D) for cross attention (both for
    ``attn+cross``), {"c_kv", "k_rope"} for MLA; a recurrent mixer's
    final state.  With ``lines`` (a prefill collecting them) a
    tensor-parallel rank's lines are its block of the dense cache
    (``attention.line_rows``)."""
    h = apply_norm(p["norm1"], x, cfg)
    if b.mixer in ("attn", "attn+cross"):
        o, state = attn.multihead_attention(p["mixer"], h, cfg,
                                            positions=positions,
                                            rope=ropes["attn"], lines=lines)
        if b.mixer == "attn+cross":
            x = x + cfg.residual_scale * o
            h2 = apply_norm(p["norm_x"], x, cfg)
            o, cross = _cross_attend(p["cross"], h2, cross_src, cfg, lines)
            state = {**state, **cross}
    elif b.mixer == "cross_attn":
        o, state = _cross_attend(p["mixer"], h, cross_src, cfg, lines)
    elif b.mixer == "mla":
        o, state = mla_mod.mla_attention(p["mixer"], h, cfg, positions,
                                         rope=ropes["mla"], lines=lines)
    else:
        o, state = _recurrent_mixer(p["mixer"], b, h, cfg, None)
    x = x + cfg.residual_scale * o
    x, aux = _ffn_tail(p, b, x, cfg)
    return x, aux, state


def _cross_attend_cached(p, x: torch.Tensor, ck: torch.Tensor,
                         cv: torch.Tensor, cfg: ModelConfig,
                         src_len: int) -> torch.Tensor:
    """One query token a row against a cross-attention cache ck/cv (B,
    S_src rounded, KV, hd) of ``src_len`` real lines, unmasked over them
    and gated: the reference's ``_cross_attend_cached`` (q-norm on q only,
    no soft cap) through ``attention.dense_attention`` with every row's
    last line ``src_len - 1``; a decode rank on cut lines runs
    ``attention.cross_decode``."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = attn._heads(x, p["wq"])
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
    if attn.cut_lines(cfg):
        out = attn.cross_decode(p, q, ck, cv, cfg, src_len, x.dtype)
    else:
        last = torch.full((B,), src_len - 1, dtype=torch.int32,
                          device=x.device)
        with named_scope("paged_attention"):
            o = attn.dense_attention(q.reshape(B, KV, H // KV, hd), ck, cv,
                                     last, scale=1.0 / (hd ** 0.5)
                                     ).reshape(B, 1, H, hd)
        out = attn._out_proj(o.to(x.dtype), p["wo"], cfg)
    if "gate" in p:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out


def _replace_state(cache: Dict[str, torch.Tensor],
                   new: Dict[str, torch.Tensor]) -> None:
    """A dense decode step's recurrent state, written into the persistent
    cache leaves in place (every row advances)."""
    for name, old in cache.items():
        old.copy_(new[name])


def apply_block_decode(p, b: BlockDef, x: torch.Tensor,
                       pool: Dict[str, torch.Tensor], pos: torch.Tensor,
                       cfg: ModelConfig,
                       block_tables: Optional[torch.Tensor],
                       page_size: int, ropes: Dict[str, attn.Rope],
                       pipeline: Optional[str] = None,
                       active: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One-token decode through a block (caches updated in place).

    Paged (``block_tables`` (B, n_blocks)): GQA / MLA page pools, and
    ``pipeline`` the attention kernel's page-streaming schedule; a
    recurrent mixer's state rows (B = num_slots) advance for the slots
    ``active`` (B,) bool marks and keep their bytes elsewhere, so a packed
    step cannot clobber a slot that is idle or mid-prefill.  Dense
    (``block_tables`` None, the static engine): ``pool`` is the block's
    dense cache (:func:`block_cache_defs`), every row writes at ``pos``
    and every recurrent row advances."""
    h = apply_norm(p["norm1"], x, cfg)
    dense = block_tables is None
    if b.mixer == "attn" and dense:
        o = attn.decode_attention(p["mixer"], h, pool, pos, cfg,
                                  rope=ropes["attn"])
    elif b.mixer == "attn":
        o = attn.decode_attention_paged(p["mixer"], h, pool, block_tables,
                                        pos, cfg, page_size=page_size,
                                        rope=ropes["attn"], pipeline=pipeline)
    elif b.mixer == "cross_attn":
        o = _cross_attend_cached(p["mixer"], h, pool["ck"], pool["cv"], cfg,
                                 cross_len(cfg, b))
    elif b.mixer == "attn+cross":
        o = attn.decode_attention(p["mixer"], h, pool, pos, cfg,
                                  rope=ropes["attn"])
        x = x + cfg.residual_scale * o
        h2 = apply_norm(p["norm_x"], x, cfg)
        o = _cross_attend_cached(p["cross"], h2, pool["ck"], pool["cv"], cfg,
                                 cross_len(cfg, b))
    elif b.mixer == "mla" and dense:
        o = mla_mod.mla_decode(p["mixer"], h, pool, pos, cfg,
                               rope=ropes["mla"])
    elif b.mixer == "mla":
        o = mla_mod.mla_decode_paged(p["mixer"], h, pool, block_tables, pos,
                                     cfg, page_size=page_size,
                                     rope=ropes["mla"], pipeline=pipeline)
    else:
        o, new = _recurrent_mixer(p["mixer"], b, h, cfg, pool)
        if dense:
            _replace_state(pool, new)
        else:
            _freeze(pool, new, active)
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg)[0]


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
    return _ffn_tail(p, b, x, cfg)[0]


def apply_block_prefill_chunk(p, b: BlockDef, x: torch.Tensor,
                              pool: Dict[str, torch.Tensor], offset: Offset,
                              block_table: torch.Tensor, cfg: ModelConfig,
                              page_size: int, ropes: Dict[str, attn.Rope],
                              slot: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Prefill one chunk of ONE request through a block (pool updated in
    place).  x (1,T,D) at positions offset..offset+T-1 (``offset`` an int
    or a 0-d int32 device tensor).  A recurrent mixer starts from row
    ``slot`` ((1,) long index) of its state leaves and writes it back."""
    h = apply_norm(p["norm1"], x, cfg)
    if b.mixer == "attn":
        o = attn.prefill_attention_paged(p["mixer"], h, pool, block_table,
                                         offset, cfg, page_size=page_size,
                                         rope=ropes["attn"])
    elif b.mixer == "mla":
        o = mla_mod.mla_prefill_paged(p["mixer"], h, pool, block_table,
                                      offset, cfg, page_size=page_size,
                                      rope=ropes["mla"])
    else:
        st = {k: v.index_select(0, slot) for k, v in pool.items()}
        o, new = _recurrent_mixer(p["mixer"], b, h, cfg, st)
        for k, v in pool.items():
            v.index_copy_(0, slot, new[k].to(v.dtype))
    x = x + cfg.residual_scale * o
    return _ffn_tail(p, b, x, cfg)[0]


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

REMAT_MODES = ("full", "dots", "none")


def remat_mode(cfg: ModelConfig, remat: Optional[bool] = None) -> str:
    """The activation checkpointing a full forward runs under: ``remat``
    False forces "none" and True "full" (the reference's override);
    None takes ``cfg.remat``."""
    mode = {False: "none", True: "full"}.get(remat, cfg.remat)
    if mode not in REMAT_MODES:
        raise ValueError(f"remat {mode!r} not in {REMAT_MODES}")
    return mode


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of the 2-D products (``mm`` / ``addmm``: the weight products, which
    have no batch dim), recompute the rest, batched products included,
    so the (.., S, S) attention scores and the per-expert products are
    not kept (the counterpart of ``checkpoint_dots_with_no_batch_dims``)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _rematted(fn, mode: str):
    """``fn`` under activation checkpointing ``mode``: "full" saves only
    its inputs and recomputes the rest in backward, "dots" also saves the
    2-D matrix products' outputs, "none" is ``fn``.  With grad disabled
    (serving) nothing is saved for backward, so ``fn`` runs as is."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    # the models draw no random numbers, so no RNG state is kept
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _unstack(tree: Any, reps: int) -> List[Any]:
    """The ``reps`` layers of a stacked ``(reps, ...)`` dict tree, as
    views: one ``unbind`` a leaf, whose backward stacks the layers'
    gradients once (indexing layer by layer would add a full-size zero
    gradient a layer)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: per[k][r] for k in tree} for r in range(reps)]
    return list(tree.unbind(0))


def _run_encoder(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
                 remat: Optional[bool] = None) -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub) frame embeddings
    (B, frames, D): learned positions, ``n_encoder_layers`` causal GQA
    blocks without RoPE (the reference's encoder passes no positions, so
    its attention takes ``cfg.causal``), a final norm.  Each block is
    checkpointed when the remat mode is "full" (the reference's
    encoder checkpoints under "full" only)."""
    enc = params["encoder"]
    F = enc_embeds.shape[1]
    x = enc_embeds + enc["pos"][:F].to(enc_embeds.dtype)[None]
    no_rope = {"attn": None}

    def body(y, layer_p):
        return apply_block_full(layer_p["b0"], ENCODER_BLOCK, y, cfg, None,
                                no_rope)[0]

    mode = remat_mode(cfg, remat)
    body = _rematted(body, "full" if mode == "full" else "none")
    for layer_p in _unstack(enc["blocks"], cfg.n_encoder_layers):
        x = body(x, layer_p)
    return apply_norm(enc["final_norm"], x, cfg)


def forward_full(params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_embeds: Optional[torch.Tensor] = None,
                 img_embeds: Optional[torch.Tensor] = None,
                 collect_state: bool = False,
                 remat: Optional[bool] = None, cache_blocks: bool = False):
    """Full-sequence forward.  tokens (B, S) int; ``enc_embeds`` (B,
    frames, D) for an encoder-decoder model (run through the encoder),
    ``img_embeds`` (B, n_img, D) for a vision model: the cross-attention
    source, cast to the model dtype.  Each layer runs under the
    checkpointing of :func:`remat_mode` (``cfg.remat`` unless ``remat``
    overrides it; only while grad is enabled).

    Returns (logits (B, S, V), aux, states): aux the float32 sum of the
    MoE blocks' load-balance losses, added in layer order (0 without
    MoE); states (with ``collect_state``) per segment ``{"b<i>": lines}``
    stacked (reps, B, S, ...) for attention blocks ((reps, B, S_src, ...)
    for their cross lines) and a recurrent block's final state (reps, B,
    ...), else None.  With ``cache_blocks`` a tensor-parallel rank's
    states are its blocks of the dense cache under the training rules
    (``attention.line_rows``: its rows of the lines where they cut
    them), the prefill a dry run walks; serving's prefill keeps its
    ranks' whole lines."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    cross_src = None
    if cfg.is_encoder_decoder:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward "
                             "needs enc_embeds")
        cross_src = _run_encoder(params, cfg, enc_embeds.to(x.dtype), remat)
    elif cfg.n_image_tokens:
        if img_embeds is None:
            raise ValueError(f"{cfg.name}: a vision forward needs "
                             "img_embeds")
        cross_src = img_embeds.to(x.dtype)
    ropes = rope_tables(cfg, positions)
    mode = remat_mode(cfg, remat)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    states: List[Any] = []
    for seg_params, (unit, reps) in zip(params["segments"], cfg.segments()):

        def body(y, a, layer_p, unit=unit):
            st = {}
            for i, b in enumerate(unit):
                y, ab, st[f"b{i}"] = apply_block_full(
                    layer_p[f"b{i}"], b, y, cfg, positions, ropes, cross_src,
                    collect_state and cache_blocks)
                if ab is not None:
                    a = a + ab
            # a layer's lines leave the body only when they are collected
            return y, a, (st if collect_state else None)

        body = _rematted(body, mode)
        per_layer = []
        for layer_p in _unstack(seg_params, reps):
            x, aux, st = body(x, aux, layer_p)
            per_layer.append(st)
        if collect_state:
            states.append(tree_map(lambda *xs: torch.stack(xs),
                                   *per_layer))
    x = apply_norm(params["final_norm"], x, cfg)
    logits = logits_from_hidden(params["embed"], x, cfg)
    return logits, aux, (states if collect_state else None)


def decode_one(params, cfg: ModelConfig, caches: List[Any],
               token: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One decode step of the static engine over dense caches (updated in
    place).  token (B,1); pos (B,) int32 — the reference's scalar
    position, one per row, so a captured step reads it from a persistent
    buffer.  Returns logits (B, V)."""
    x = embed_tokens(params["embed"], token, cfg, pos[:, None])
    ropes = rope_tables(cfg, pos[:, None])
    for seg_params, seg_cache, (unit, reps) in zip(
            params["segments"], caches, cfg.segments()):
        for r in range(reps):
            layer_p, layer_c = _layer(seg_params, r), _layer(seg_cache, r)
            for i, b in enumerate(unit):
                x = apply_block_decode(layer_p[f"b{i}"], b, x,
                                       layer_c[f"b{i}"], pos, cfg, None, 0,
                                       ropes)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params["embed"], x, cfg)[:, 0, :]


def decode_one_paged(params, cfg: ModelConfig, pools: List[Any],
                     block_tables: torch.Tensor, token: torch.Tensor,
                     pos: torch.Tensor, *, page_size: int,
                     pipeline: Optional[str] = None,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step over the packed slot batch.

    token (B,1) (B = num_slots); pos (B,) int32 per-slot positions;
    block_tables (B, n_blocks) int32; active (B,) bool marks the slots
    holding a decoding request (needed when the model has a recurrent
    mixer: the other slots' state rows are frozen).  Idle lanes point at
    the trash page and compute garbage the engine discards.  The pools
    are updated in place; returns logits (B, V).  Shapes do not depend
    on which slots are live.  ``pipeline`` selects the paged-attention
    kernels' page-streaming schedule (kernels/ops.py; None = process
    default).

    MoE caveat, as in the reference: idle lanes' garbage tokens enter
    expert routing and can move capacity cutoffs for live tokens."""
    if active is None and has_recurrent(cfg):
        raise ValueError(f"{cfg.name}: a decode step over recurrent state "
                         "rows needs the active (B,) mask")
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
                                       pipeline, active)
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
                        offset: Offset, *, page_size: int,
                        slot: Optional[Offset] = None) -> torch.Tensor:
    """Prefill one chunk of one request into its pages and state rows
    (updated in place).

    tokens (1,T) at positions offset..offset+T-1; block_table (n_blocks,)
    and ``slot`` for this request's slot.  ``offset`` and ``slot`` are
    ints or 0-d int32 tensors on the tokens' device: nothing here reads
    them on the host, so a captured chunk replays at any offset and for
    any slot, and its shapes depend on T and n_blocks alone (the
    attention walks the whole table row).  Returns last-token logits (1,
    V).  Repeated calls over consecutive chunks equal one whole-prompt
    prefill (for dense FFNs; an MoE FFN's capacity depends on the tokens
    per call): attention chunks attend to every page written before, and
    recurrent mixers carry their slot's rows from chunk to chunk (a
    model with one needs ``slot``)."""
    T = tokens.shape[1]
    slot_idx = None
    if has_recurrent(cfg):
        if slot is None:
            raise ValueError(f"{cfg.name}: a prefill chunk over recurrent "
                             "state rows needs its slot")
        slot_idx = _slot_index(slot, tokens.device)
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
                                              ropes, slot_idx)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params["embed"], x[:, -1:], cfg)[:, 0, :]
