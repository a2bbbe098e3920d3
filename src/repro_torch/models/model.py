"""Model facade: defs, init, prefill, paged decode and verification, and
the static engine's dense caches and decode step — the surface the serve
engines use (the reference's ``models/model.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..device import resolve_device
from . import transformer as tfm
from .common import ModelConfig
from .params import (instantiate, torch_dtype, tree_count, tree_map,
                     tree_nbytes)


def model_param_defs(cfg: ModelConfig):
    return tfm.model_defs(cfg)


def param_shardings(cfg: ModelConfig, mesh, rules=None):
    """The spec of every parameter leaf on ``mesh`` under ``rules``
    (parallel/sharding.py ``DEFAULT`` when None)."""
    from ..parallel import sharding as shd
    return shd.tree_specs(model_param_defs(cfg), mesh, rules or shd.DEFAULT)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = "cuda", *, specs=None,
                mesh=None):
    """Random weights drawn from ``generator`` (a fresh one seeded 0 on
    ``device`` when None), placed on ``device``.  With ``specs`` (a spec
    tree, e.g. serve/shard.py ``param_pspecs``) and ``mesh``, each leaf
    is drawn whole from the same generator sequence and replaced by this
    rank's block before the next is drawn: every rank of a mesh gets its
    shard of the same weights, and none holds the whole tree."""
    from ..parallel.sharding import shard_leaf
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    defs = model_param_defs(cfg)
    with torch.no_grad():
        if specs is None:
            return prepare_params(instantiate(defs, generator, dev), cfg)
        return prepare_params(tree_map(
            lambda d, sp: shard_leaf(d.instantiate(generator, dev), sp,
                                     mesh), defs, specs), cfg)


def prepare_params(params, cfg: ModelConfig):
    """Attach the model-dtype copy of a tied embedding (``tok_cast``) that
    the logits read, built once here instead of once per step.  Returns a
    new top-level dict; the numerics are those of casting per call."""
    if not cfg.tie_embeddings or "tok_cast" in params["embed"]:
        return params
    embed = dict(params["embed"])
    embed["tok_cast"] = embed["tok"].to(torch_dtype(cfg.dtype))
    return {**params, "embed": embed}


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors: every leaf's shape and dtype,
    no storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.torch_dtype,
                                          device="meta"),
                    model_param_defs(cfg))


def cache_param_defs(cfg: ModelConfig, batch: int, max_len: int):
    """ParamDefs of the dense decode caches (:func:`init_cache`)."""
    return tfm.cache_defs(cfg, batch, max_len)


def drop_cast(params):
    """``params`` without the tied embedding's cached cast
    (:func:`prepare_params`): a new top-level dict of the same tensors.
    Training leaves the cast out: it is neither trained nor counted by
    the optimizer nor checkpointed."""
    if "tok_cast" not in params.get("embed", {}):
        return params
    embed = {k: v for k, v in params["embed"].items() if k != "tok_cast"}
    return {**params, "embed": embed}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda"):
    """Zeroed dense decode caches (transformer.cache_defs: sequence axes
    rounded up to a multiple of 16) for ``batch`` rows of up to
    ``max_len`` tokens, on ``device``."""
    return instantiate(tfm.cache_defs(cfg, batch, max_len), None,
                       resolve_device(device))


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in float32.  logits (B, S, V); labels (B, S);
    ``mask`` (B, S) weights each token (all ones when None)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)                          # (B, S)
    ll = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S), labels (B, S); optional ``loss_mask``,
    ``enc_embeds`` / ``img_embeds``.  The forward runs under
    ``cfg.remat``.  Returns (loss = nll + aux, {"nll", "aux"})."""
    logits, aux, _ = tfm.forward_full(
        params, cfg, batch["tokens"],
        enc_embeds=batch.get("enc_embeds"),
        img_embeds=batch.get("img_embeds"))
    nll = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return nll + aux, {"nll": nll, "aux": aux}


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            enc_embeds: Optional[torch.Tensor] = None,
            img_embeds: Optional[torch.Tensor] = None):
    """Full-context forward collecting decode state (``enc_embeds`` /
    ``img_embeds``: the cross-attention source of an encoder-decoder or
    vision model).  Returns (last_logits (B, V), states) — per segment,
    attention lines stacked (reps, B, S, ...), cross lines (reps, B,
    S_src, ...) and recurrent final states (reps, B, ...), ready for
    ``PagedKVCache.write_prefill_states`` or the static engine's dense
    caches."""
    logits, _, states = tfm.forward_full(params, cfg, tokens,
                                         enc_embeds=enc_embeds,
                                         img_embeds=img_embeds,
                                         collect_state=True, remat=False)
    return logits[:, -1, :], states


def prefill_padded(params, cfg: ModelConfig, tokens: torch.Tensor,
                   true_len: Union[int, torch.Tensor]):
    """Whole-prompt prefill over a length-bucketed (zero-padded) buffer.
    tokens (B, S_padded) with the real prompt in the first ``true_len``
    positions; causal masking keeps the prefix rows equal to an unpadded
    prefill.  ``true_len`` is an int or a 0-d int32 tensor on the tokens'
    device, read by a fixed-shape gather (so a captured bucket replays at
    any length).  Returns (last_logits (B, V) at position true_len-1,
    states)."""
    logits, _, states = tfm.forward_full(params, cfg, tokens,
                                         collect_state=True, remat=False)
    last = torch.as_tensor(true_len, device=logits.device).reshape(1) - 1
    return logits.index_select(1, last.long())[:, 0], states


def decode_step(params, cfg: ModelConfig, caches: List[Any],
                token: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One token for every row of a static batch against dense caches
    (updated in place).  token (B,1); pos (B,) int32 (the reference's
    scalar, one per row).  Returns logits (B, V).  GQA self and cross
    attention run ``kernels.ops.paged_attention`` over the caches viewed
    as pools (the hand-written kernel on the card)."""
    return tfm.decode_one(params, cfg, caches, token, pos)


def paged_cache_defs(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int):
    """Paged decode-cache defs (see serve/kv_cache.py for the allocator)."""
    return tfm.paged_cache_defs(cfg, num_slots, num_pages, page_size)


def decode_step_paged(params, cfg: ModelConfig, pools: List[Any],
                      block_tables: torch.Tensor, token: torch.Tensor,
                      pos: torch.Tensor, *, page_size: int,
                      pipeline: Optional[str] = None,
                      active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode token per slot against the paged cache (pools and state
    rows updated in place).  token (B,1); pos (B,) int32; block_tables
    (B, n_blocks) int32; active (B,) bool, the decoding slots, whose
    recurrent state rows alone advance (required when the model has a
    recurrent mixer).  Returns logits (B, V).  ``pipeline`` selects the
    paged-attention kernel's page-streaming schedule ("off" / "double";
    None = the process default of kernels/ops.py)."""
    return tfm.decode_one_paged(params, cfg, pools, block_tables, token, pos,
                                page_size=page_size, pipeline=pipeline,
                                active=active)


def decode_step_verify_paged(params, cfg: ModelConfig, pools: List[Any],
                             block_tables: torch.Tensor, tokens: torch.Tensor,
                             pos: torch.Tensor, *, page_size: int,
                             pipeline: Optional[str] = None) -> torch.Tensor:
    """Multi-token speculative verification: score tokens (B, T) — per
    slot the chain [last committed token, draft_1..draft_k] at positions
    ``pos + t`` — in one weight pass against the paged cache (pools
    updated in place).  Returns logits (B, T, V).  Attention/MLA archs
    only."""
    return tfm.decode_verify_paged(params, cfg, pools, block_tables, tokens,
                                   pos, page_size=page_size,
                                   pipeline=pipeline)


def prefill_chunk_paged(params, cfg: ModelConfig, pools: List[Any],
                        block_table: torch.Tensor, tokens: torch.Tensor,
                        offset, *, page_size: int, slot=None) -> torch.Tensor:
    """Prefill one chunk of one request into its pages and its slot's
    state rows (chunked prefill).  ``offset`` and ``slot`` are ints or 0-d
    int32 device tensors.  Returns last-token logits (1, V)."""
    return tfm.prefill_chunk_paged(params, cfg, pools, block_table, tokens,
                                   offset, page_size=page_size, slot=slot)


def param_count(cfg: ModelConfig) -> int:
    return tree_count(model_param_defs(cfg))


def param_bytes(cfg: ModelConfig) -> int:
    return tree_nbytes(model_param_defs(cfg))
