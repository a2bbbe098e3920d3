"""Ledger <-> walk cross-checks of the serve steps, and the HBM-capacity
axis: the JAX package's ``serve/crosscheck.py`` in PyTorch.

The scheduler's per-request roofline ledger prices one decode token
*analytically* (scheduler.decode_token_flops/bytes).  This module closes
the loop the way the paper cross-checks its FLOP and traffic counters
against what the machine reports (its section 2.4): walk the aten ops one
call of the engine's step dispatches (core/roofline/op_cost.py, the
port's counterpart of the reference's HLO cost walk) and compare W and Q.

The walks run on *abstract* inputs, the counterpart of lowering with
``jax.ShapeDtypeStruct``: the live parameters, pools and tables become
fake tensors (``FakeTensorMode``) of the same shapes and dtypes on the
``cpu`` device, so ``kernels/ops.py`` picks the plain versions (the
reference's ``backend="jnp"``) and nothing on the card is read, written
or allocated: a full-width engine can be walked beside its live pools.

One correction is applied before comparing, as ``substitute_flash`` does:
the plain paged attention gathers its pages into a (B, S, KV, hd) copy
(the ``paged_attention`` scope's bytes), which the kernel never makes; its
traffic is the page walk itself, ``(L + 1)`` lines of the pool tree.
And it scores every line of the table, where the kernel attends the live
lines only.  So the scope's bytes are swapped for the kernel pricing
(substitute.substitute_paged_attention) and its FLOPs scaled to the lines
the kernel attends, and the rest of the step is compared as walked.  The
walk also splits its bytes into parameters, KV pools and activations:
every aten op is a kernel of its own, so the unfused activation traffic
the ledger leaves out on purpose is named, not hidden
(``activation_bytes``).  The weights + KV bytes are held against the
ledger up to terms counted from the parameter and pool trees alone
(``_compare``), so a wrong ledger formula fails the hold.

* :func:`crosscheck_decode` / :func:`crosscheck_verify`: the decode and
  speculative verification steps (the verify substitution prices the
  shared page walk, (L + 2T - 1) lines);
* :func:`step_cost_analysis`: the decode body the engine replays plus its
  sampler, W and Q for the time budget;
* :func:`crosscheck_vmem`: the ledger's ``vmem`` bytes (the CUDA kernels'
  on-chip count, kernels/paged_attention.py) against an independent walk
  of the kernels' launch grids, block by block;
* :func:`crosscheck_host`: the swap pricing against the walk of the
  gather-and-pack ``PagedKVCache.swap_out`` runs;
* :func:`overlapped_levels` / :func:`crosscheck_overlap`: the ``vmem``
  level under ``pipeline="double"`` and the ``ici`` level under the
  tensor-parallel ring epilogues (``EngineConfig.overlap="ring"``);
* :func:`crosscheck_collectives`: a sharded engine's charged
  card-to-card bytes against the ``c10d`` collectives one of its decode
  steps dispatches (core/roofline/op_collectives.py; a real step on every
  rank, since fake tensors cannot cross a process group);
* :func:`capacity_report`: the HBM-capacity axis (pages per request
  beside the weights, and the batch the card's memory would hold), per
  replica and summed over a ``Cluster``'s.
"""

from __future__ import annotations

import contextlib
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.roofline import extract
from ..core.roofline.substitute import (paged_attention_kernel_bytes,
                                        substitute_paged_attention)
from ..kernels import paged_attention as kpa
from ..kernels import quantize as kvq
from ..models import decode_step_paged, decode_step_verify_paged
from ..models import ssm, xlstm
from ..models.common import param_counts
from ..models.params import torch_dtype, tree_leaves, tree_map
from . import sampling
from .kv_cache import gather_slot_pages, pack_leaves, split_leaves
from .scheduler import (attn_kernel_vmem_bytes, decode_collective_count,
                        decode_step_ici_bytes, decode_token_bytes,
                        decode_token_flops, kv_line_bytes,
                        params_bytes_active, slot_swap_bytes)


# --------------------------------------------------------------------------
# Abstract walks
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _abstract():
    """Fake tensors for the walk: a ``FakeTensorMode`` in which
    ``fake(t)`` gives a CPU stand-in of ``t``'s shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        yield lambda t: torch.empty(t.shape, dtype=t.dtype, device="cpu")


def _live(engine):
    if engine._kv is None:
        raise ValueError("engine has no live pool; submit work or reset()")
    return engine.cfg, engine._kv, engine.ecfg


def decode_step_character(engine) -> extract.StepCharacter:
    """Walk the engine's decode step (``models.decode_step_paged``, plain
    versions) on fake CPU tensors of its live shapes, every slot active,
    and characterize it; state rows are their own byte category."""
    cfg, kv, e = _live(engine)
    B = e.num_slots
    with _abstract() as fake:
        params = tree_map(fake, engine.params)
        pools = tree_map(fake, kv.pools)
        paged, rows = split_leaves(pools, kv._paged)
        bt = torch.zeros((B, kv.blocks_per_slot), dtype=torch.int32)
        tok = torch.zeros((B, 1), dtype=torch.int32)
        pos = torch.zeros((B,), dtype=torch.int32)
        active = torch.ones((B,), dtype=torch.bool)
        return extract.characterize(
            decode_step_paged, params, cfg, pools, bt, tok, pos,
            page_size=e.page_size, pipeline=e.pipeline, active=active,
            params=params, pools=paged, states=rows)


def verify_step_character(engine, n_tokens: int) -> extract.StepCharacter:
    """Walk the speculative engine's multi-token verification step
    (``models.decode_step_verify_paged``) at its live shapes."""
    cfg, kv, e = _live(engine)
    B = e.num_slots
    with _abstract() as fake:
        params = tree_map(fake, engine.params)
        pools = tree_map(fake, kv.pools)
        bt = torch.zeros((B, kv.blocks_per_slot), dtype=torch.int32)
        toks = torch.zeros((B, int(n_tokens)), dtype=torch.int32)
        pos = torch.zeros((B,), dtype=torch.int32)
        return extract.characterize(
            decode_step_verify_paged, params, cfg, pools, bt, toks, pos,
            page_size=e.page_size, pipeline=e.pipeline, params=params,
            pools=pools)


# Relative bar of the bytes hold.  Every term of it is an integer byte
# count but the ledger's per-request share of the weights (a float64
# division, summed over the requests), so a right ledger leaves float64
# rounding only, orders of magnitude under this bar, and a wrong one (a
# weight, norm, line or table priced otherwise) leaves its bytes.
BYTES_HOLD_TOL = 1e-9


def _tree_paths(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict / list, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _tree_paths(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


# how often one decode step reads each incoming state leaf of a mixer
# (the mixers' modules say where); the freeze reads every leaf once more
_STATE_READS = {"mamba": ssm.DECODE_STATE_READS,
                "mlstm": xlstm.MLSTM_DECODE_STATE_READS,
                "slstm": xlstm.SLSTM_DECODE_STATE_READS}


def _state_terms(engine, n_active: int) -> Dict[str, float]:
    """The state rows' terms of the bytes hold, counted from the pool
    tree's state leaves (``state_defs``) alone: ``state_row_bytes``, one
    slot's rows; ``state_freeze_read_bytes``, the freeze's read of every
    slot's old rows (``torch.where`` of new and old rows); and
    ``state_reread_bytes``, the reads of an incoming leaf beyond the
    first inside the mixers (``*DECODE_STATE_READS``), every slot; and
    ``state_idle_bytes``, the rows of the slots not decoding, which the
    step reads and writes and the ledger, priced per request, does not."""
    cfg, kv = engine._kv.cfg, engine._kv
    B = kv.num_slots
    row = reread = 0.0
    for seg_pool, (unit, _) in zip(kv.pools, cfg.segments()):
        for i, b in enumerate(unit):
            reads = _STATE_READS.get(b.mixer)
            if reads is None:
                continue
            for name, t in seg_pool[f"b{i}"].items():
                leaf = t.numel() // B * t.element_size()
                row += leaf
                reread += (reads[name] - 1) * leaf
    return {"state_row_bytes": row,
            "state_freeze_read_bytes": B * row,
            "state_reread_bytes": B * reread,
            "state_idle_bytes": (B - n_active) * 2 * row}


# the leaves of each recurrent mixer that the ledger's parameter count
# (models/common.py ``_block_params``, the reference's) leaves out: the
# gate biases and skips, and the sLSTM's output projection
_OMITTED = {"mamba": ("D_skip",), "mlstm": ("bi", "bf", "skip"),
            "slstm": ("b_z", "b_i", "b_f", "b_o", "out_proj")}


def _omitted_ids(engine) -> set:
    """ids of the parameter leaves named by ``_OMITTED``."""
    out = set()
    for seg, (unit, _) in zip(engine.params.get("segments", []),
                              engine.cfg.segments()):
        for i, b in enumerate(unit):
            mixer = seg[f"b{i}"]["mixer"]
            out |= {id(mixer[n]) for n in _OMITTED.get(b.mixer, ())}
    return out


def _tree_terms(engine, n_rows: int) -> Dict[str, float]:
    """What one step reads of the parameters and writes of the pools
    beyond the ledger's pricing, counted from the trees alone, never from
    the ledger's formulas (so a wrong formula cannot hide in them):

    * ``lookup_bytes``: the ``n_rows`` rows of ``embed/tok`` the embedding
      lookup reads (the ledger prices no lookup);
    * ``untied_table_bytes``: an untied model's input table at the model
      dtype, which the ledger charges as a pass the step never makes (it
      reads the looked-up rows only); 0 when tied, where the table is the
      logits head the step reads.  An exception, reported apart;
    * ``norm_bytes``: every norm scale (a leaf under a ``*norm*`` key),
      which the ledger does not price;
    * ``wide_bytes``: what leaves stored wider than the model dtype read
      beyond it (the ledger prices every weight at the model dtype);
    * ``expert_bytes``: the routed experts' weights, which the global
      dispatch reads for every expert, and ``active_expert_bytes``, their
      top-k share, which the ledger charges;
    * ``omitted_bytes``: the recurrent mixers' leaves the ledger's
      parameter count leaves out (``_OMITTED``), read in full;
    * ``line_bytes``: one token's cache line over every pool leaf (scales
      too), from the pool tree: the unit of the appended lines and of the
      kernel's page walk."""
    cfg, kv = engine.cfg, engine._kv
    isize = torch_dtype(cfg.dtype).itemsize
    experts = {id(ffn[w]) for seg in engine.params.get("segments", [])
               for blk in seg.values() for ffn in [blk.get("ffn", {})]
               if "router" in ffn
               for w in ("w_up", "w_gate", "w_down") if w in ffn}
    omitted = _omitted_ids(engine)
    out = dict.fromkeys(("lookup_bytes", "untied_table_bytes", "norm_bytes",
                         "wide_bytes", "expert_bytes", "omitted_bytes"),
                        0.0)
    for path, t in _tree_paths(engine.params):
        nbytes = t.numel() * t.element_size()
        if id(t) in omitted:
            out["omitted_bytes"] += nbytes
        elif path == "/embed/tok":
            out["lookup_bytes"] = n_rows * t.shape[-1] * t.element_size()
            if not cfg.tie_embeddings:
                out["untied_table_bytes"] = t.numel() * isize
        elif "norm" in path:
            out["norm_bytes"] += nbytes
        elif id(t) in experts:
            out["expert_bytes"] += nbytes
        elif t.element_size() > isize:
            out["wide_bytes"] += t.numel() * (t.element_size() - isize)
    out["active_expert_bytes"] = (out["expert_bytes"] * cfg.moe_top_k
                                  / max(cfg.n_experts, 1))
    out["line_bytes"] = kv.page_bytes / kv.page_size
    return out


def _kernel_priced(engine, char: extract.StepCharacter, contexts: List[int],
                   line: float, n_q: int):
    """The walk's dump, and a copy with the ``paged_attention`` scope
    priced as the kernel (None without the scope): its bytes by
    ``substitute_paged_attention`` at ``line``, its FLOPs scaled from the
    table the plain version scores to the lines the kernel attends (query
    t of a slot at context L: L + t, at most the table).  Every FLOP of
    the plain versions' scope is per (query, table line), but the
    dequantization of a quantized pool, per (slot, table line), which the
    scaling prices at the queries' mean lines."""
    d = extract.character_as_dict(char)
    sub = substitute_paged_attention(d, contexts, line, n_q=n_q)
    if sub is None:
        return d, None
    kv = engine._kv
    table = kv.blocks_per_slot * kv.page_size
    attended = sum(kpa._visible(L, t, kv.blocks_per_slot, kv.page_size)
                   for L in contexts for t in range(n_q))
    scope = d["scopes"]["paged_attention"]["flops"]
    flops = scope * attended / (engine.ecfg.num_slots * n_q * table)
    sub["flops_dev"] = d["flops_dev"] - scope + flops
    sub["scopes"]["paged_attention"]["flops"] = flops
    return d, sub


def _compare(engine, char: extract.StepCharacter, analytic_flops: float,
             analytic_bytes: float, contexts: List[int], n_q: int = 1
             ) -> Dict:
    """The reference's keys (``hlo_*`` the kernel-priced walk's), plus
    the walk's split: ``param_bytes``, ``pool_bytes`` (outside the priced
    scope: the appended lines), ``kernel_bytes`` (the scope priced as the
    kernel), ``activation_bytes`` (outside the scope), ``weights_kv_bytes``
    = param + pool + kernel bytes (what the ledger prices) and its ratio,
    ``kernel_flops`` (the scope's FLOPs priced as the kernel),
    ``naive_flops``, the walk's tracked scopes as walked, ``state_bytes``
    (the state rows' category, 0 without recurrent mixers), and the bytes
    hold's terms.

    The bytes hold.  ``bytes_residual`` = the walk's weights + KV bytes
    (an MoE step's with the active experts' bytes in the place of the
    ``moe_experts`` scope's parameter bytes: ``weights_kv_dense_bytes``)
    less the ledger's Q less ``named_bytes``, the terms
    :func:`_tree_terms` counts from the trees: lookup rows + norm scales
    + wide leaves + the recurrent leaves the ledger omits + the appended
    lines (num_slots x T x ``line_bytes``) - the untied table + the state
    rows' freeze read, re-reads and idle slots (:func:`_state_terms`).  The kernel's page walk is priced at
    the pool tree's line, not the ledger's.  A right ledger leaves float64
    rounding; the hold is |residual| <= ``bytes_tolerance`` x the
    ledger's Q (``BYTES_HOLD_TOL``)."""
    n_rows = engine.ecfg.num_slots * n_q
    terms = _tree_terms(engine, n_rows)
    terms.update(_state_terms(engine, len(contexts)))
    line = terms["line_bytes"]
    d, sub = _kernel_priced(engine, char, contexts, line, n_q)
    walk = sub or d
    scope = char.scopes.get("paged_attention", {})
    kernel = paged_attention_kernel_bytes(contexts, line, n_q=n_q) \
        if sub else 0.0
    by = char.bytes_by_category
    pool = by["pool"] - scope.get("pool_bytes", 0.0)
    state = by.get("state", 0.0)
    weights_kv = by["param"] + pool + kernel + state
    experts_walked = char.scopes.get("moe_experts", {}).get("param_bytes",
                                                            0.0)
    dense = weights_kv - experts_walked + terms["active_expert_bytes"]
    named = (terms["lookup_bytes"] + terms["norm_bytes"]
             + terms["wide_bytes"] + terms["omitted_bytes"] + n_rows * line
             - terms["untied_table_bytes"]
             + terms["state_freeze_read_bytes"]
             + terms["state_reread_bytes"] + terms["state_idle_bytes"])
    return {
        "analytic_flops": analytic_flops,
        "analytic_bytes": analytic_bytes,
        "hlo_flops": walk["flops_dev"],
        "hlo_flops_raw": d["flops_dev"],
        "hlo_bytes": walk["hbm_bytes_dev"],
        "hlo_bytes_raw": d["hbm_bytes_dev"],
        "scope_bytes_raw": scope.get("bytes", 0.0),
        "kernel_flops": (walk["scopes"]["paged_attention"]["flops"]
                         if sub else 0.0),
        "flops_ratio": analytic_flops / max(walk["flops_dev"], 1.0),
        "bytes_ratio": analytic_bytes / max(walk["hbm_bytes_dev"], 1.0),
        "substituted": sub is not None,
        "contexts": contexts,
        "param_bytes": by["param"],
        "pool_bytes": pool,
        "kernel_bytes": kernel,
        "state_bytes": state,
        "activation_bytes": (by["activation"]
                             - scope.get("activation_bytes", 0.0)),
        "weights_kv_bytes": weights_kv,
        "weights_kv_ratio": analytic_bytes / max(weights_kv, 1.0),
        "experts_walked_bytes": experts_walked,
        "weights_kv_dense_bytes": dense,
        "weights_kv_dense_ratio": analytic_bytes / max(dense, 1.0),
        **terms,
        "ledger_line_bytes": kv_line_bytes(engine.cfg),
        "named_bytes": named,
        "bytes_residual": dense - analytic_bytes - named,
        "bytes_tolerance": BYTES_HOLD_TOL,
        "naive_flops": d["cost_raw"]["naive_flops"],
        "scopes": d["scopes"],
    }


def bytes_held(out: Dict) -> bool:
    """The bytes hold of a :func:`crosscheck_decode` /
    :func:`crosscheck_verify` result (see ``_compare``)."""
    return (abs(out["bytes_residual"])
            <= out["bytes_tolerance"] * out["analytic_bytes"])


def crosscheck_decode(engine, requests: Optional[List] = None) -> Dict:
    """Compare the analytic ledger's W/Q for one decode step against the
    walk of the step (kernel-substituted; see the module docstring).
    ``requests`` defaults to the engine's currently decoding requests.
    Returns both sides, their ratios, and the walk's byte split."""
    cfg = engine.cfg
    if requests is None:
        requests = engine._sched.decode_requests()
    if not requests:
        raise ValueError("no decoding requests to cross-check")
    contexts = [r.context_len for r in requests]
    n_active = len(contexts)
    analytic_flops = sum(decode_token_flops(cfg, L) for L in contexts)
    analytic_bytes = sum(decode_token_bytes(cfg, L, n_active)
                         for L in contexts)
    return _compare(engine, decode_step_character(engine), analytic_flops,
                    analytic_bytes, contexts)


def crosscheck_verify(engine, requests: Optional[List] = None,
                      n_tokens: Optional[int] = None) -> Dict:
    """Ledger <-> walk cross-check for ONE speculative verification step.
    The analytic side is what RooflineLedger.add_verify_step charges each
    request: T scored tokens per weight pass, one shared page walk.
    ``engine`` is a serve.spec.SpecEngine (or any engine, with
    ``n_tokens`` given)."""
    cfg = engine.cfg
    if n_tokens is None:
        n_tokens = engine.scfg.k + 1
    T = n_tokens
    if requests is None:
        requests = engine._sched.decode_requests()
    if not requests:
        raise ValueError("no decoding requests to cross-check")
    contexts = [r.context_len for r in requests]
    n_active = len(contexts)
    line = kv_line_bytes(cfg)
    analytic_flops = sum(decode_token_flops(cfg, L + t)
                         for L in contexts for t in range(T))
    analytic_bytes = sum(params_bytes_active(cfg) / n_active
                         + (L + 2 * T - 1) * line for L in contexts)
    out = _compare(engine, verify_step_character(engine, T),
                   analytic_flops, analytic_bytes, contexts, n_q=T)
    out["n_tokens"] = T
    return out


def step_cost_analysis(engine) -> Dict[str, float]:
    """W and Q of the REAL decode + sample step the engine replays:
    ``Engine._decode_body`` over the engine's own persistent inputs, then
    ``sampling.sample_tokens`` with its per-slot sampling state, walked on
    fake tensors, with the ``paged_attention`` scope priced as the kernel
    (for the requests decoding now).  The time budget's compute and HBM
    rows divide these; the sampler's traffic is included."""
    from .engine import Engine
    cfg, kv, e = _live(engine)
    contexts = [r.context_len for r in engine._sched.decode_requests()]
    with _abstract() as fake:
        pools = tree_map(fake, kv.pools)
        body = types.SimpleNamespace(
            params=tree_map(fake, engine.params), cfg=cfg,
            step_cfg=engine.step_cfg, ecfg=e,
            _kv=types.SimpleNamespace(
                pools=pools, tables=types.SimpleNamespace(
                    tensor=fake(kv.tables.tensor))),
            _tok_in=types.SimpleNamespace(tensor=fake(engine._tok_in.tensor)),
            _pos_in=types.SimpleNamespace(tensor=fake(engine._pos_in.tensor)),
            _active_in=types.SimpleNamespace(
                tensor=fake(engine._active_in.tensor)))

        def step():
            return sampling.sample_tokens(
                Engine._decode_body(body), engine._seeds, engine._steps,
                engine._temps, engine._top_ks, engine._top_ps)

        paged, rows = split_leaves(pools, kv._paged)
        char = extract.characterize(step, params=body.params, pools=paged,
                                    states=rows)
    d, sub = _kernel_priced(engine, char, contexts,
                            kv.page_bytes / kv.page_size, 1) \
        if contexts else (extract.character_as_dict(char), None)
    walk = sub or d
    return {"flops": walk["flops_dev"], "bytes": walk["hbm_bytes_dev"],
            "bytes_raw": d["hbm_bytes_dev"],
            "naive_flops": d["cost_raw"]["naive_flops"],
            "substituted": sub is not None}


# --------------------------------------------------------------------------
# The on-chip level: the CUDA kernels' launch grids walked block by block
# --------------------------------------------------------------------------

def _gqa_launch_walk(pos: int, T: int, page: int, n_blocks: int, KV: int,
                     G: int, hd: int, isize: int, kv_isize: int,
                     quant: bool, pipeline: str) -> int:
    """Bytes one slot's blocks of a GQA launch load and store, walked over
    the launch grid as the sources lay it out (csrc/gqa_core.cu for bf16;
    csrc/paged_attention{,_verify,_ring}.cu for float32)."""
    rows, cap = T * G, n_blocks * page
    line = 2 * hd * kv_isize + (8 if quant else 0)
    total = 0
    if isize == 2:
        chunk = kpa.GQA_CHUNK_PAGES * page
        max_chunks = -(-n_blocks // kpa.GQA_CHUNK_PAGES)
        n_lines = min(pos + T, cap)
        nc = -(-n_lines // chunk)
        for y in range(KV * -(-rows // kpa.GQA_ROW_TILE)):
            row0 = (y // KV) * kpa.GQA_ROW_TILE
            valid = min(kpa.GQA_ROW_TILE, rows - row0)
            for c in range(max_chunks):
                c0 = c * chunk
                if c0 >= n_lines:
                    continue                  # returns at once
                c1 = min(c0 + chunk, n_lines)
                total += valid * hd * 2       # stage_q
                for t0 in range(c0, c1, kpa.GQA_TILE_LINES):
                    total += (min(t0 + kpa.GQA_TILE_LINES, c1) - t0) * line
                total += valid * (hd * 2 if nc == 1 else hd * 4 + 8)
            if nc > 1:                        # the row group's last block
                total += valid * (nc * 4 + hd * 2)    # each row's m; out
                q = hd // 4                   # threads of a row, 4 columns
                pairs = len({(i // 32, i // q) for i in range(valid * q)})
                total += nc * (pairs * 8 + valid * hd * 4)  # (m, l); acc
        return total
    if pipeline == "off" and T == 1:          # paged_attention.cu
        for _h in range(KV):
            total += G * hd * isize + min(pos + 1, cap) * line \
                + G * hd * isize
        return total
    R = kpa.f32_row_tile(rows)
    for _h in range(KV):
        for row0 in range(0, rows, R):
            nr = min(R, rows - row0)
            n_lines = min(pos + (row0 + nr - 1) // G + 1, cap)
            if pipeline == "double":          # whole pages into the ring
                staged = -(-n_lines // page) * page
            else:
                staged = n_lines
            total += nr * hd * isize + staged * line + nr * hd * isize
    return total


def _mla_launch_walk(pos: int, T: int, page: int, n_blocks: int, H: int,
                     r: int, dr: int, isize: int, kv_isize: int,
                     quant: bool) -> int:
    """Bytes one slot's blocks of an MLA call load and store: the split
    and merge kernels of csrc/mla_core.cu for bf16, one block per (8
    heads, token) of csrc/mla_paged_attention{,_verify,_ring}.cu for
    float32."""
    cap = n_blocks * page
    line = (r + dr) * kv_isize + (8 if quant else 0)
    total = 0
    for tok in range(T):
        n_lines = min(pos + tok + 1, cap)
        if isize != 2:
            for h0 in range(0, H, kpa.MLA_HEADS_PER_BLOCK):
                nh = min(kpa.MLA_HEADS_PER_BLOCK, H - h0)
                for t0 in range(0, n_lines, 16):
                    total += (min(t0 + 16, n_lines) - t0) * line
                total += nh * (r + dr) * isize + nh * r * isize
            continue
        rp = -(-r // 64) * 64
        no = min(rp, kpa.MLA_COLUMN_PART)
        chunk = kpa.MLA_CHUNK_PAGES * page
        max_chunks = -(-n_blocks // kpa.MLA_CHUNK_PAGES)
        nc = -(-n_lines // chunk)
        for x in range(max_chunks * (rp // no)):
            part, c = x % (rp // no), x // (rp // no)
            c0 = c * chunk
            if c0 >= n_lines:
                continue
            c1 = min(c0 + chunk, n_lines)
            cols = min(no, r - part * no)
            for h0 in range(0, H, kpa.MLA_HEAD_TILE):
                nh = min(kpa.MLA_HEAD_TILE, H - h0)
                total += nh * (r + dr) * 2    # stage_q
                for t0 in range(c0, c1, 16):
                    total += (min(t0 + 16, c1) - t0) * line
                total += nh * (cols * 4 + (8 if part == 0 else 0))
        total += H * (nc * (8 + 4 * r) + 2 * r)   # merge: one block a head
    return total


def kernel_walk_vmem_bytes(cfg, context_len: int, page_size: int,
                           n_q: int = 1, pipeline: str = "off",
                           n_blocks: Optional[int] = None) -> float:
    """Independent re-derivation of one slot's paged-attention on-chip
    bytes over all layers, by walking the CUDA kernels' launch grids block
    by block (the counterpart of the reference's ``_kernel_grid_vmem_walk``
    over its Pallas grids), for a block table of ``n_blocks`` pages (None:
    the pages the slot's lines fill).  The signature is
    scheduler.attn_kernel_vmem_bytes's, the closed form the ledger
    charges, which must agree with this walk; drift means a kernel's
    tiling changed without repricing the ledger."""
    if n_blocks is None:
        n_blocks = -(-(int(context_len) + int(n_q) - 1) // int(page_size))
    isize = torch_dtype(cfg.dtype).itemsize
    kv_isize = kvq.store_itemsize(cfg.kv_dtype, cfg.dtype)
    quant = kvq.is_quantized(cfg.kv_dtype)
    pos = int(context_len) - 1
    total = 0.0
    for unit, reps in cfg.segments():
        for b in unit:
            if b.mixer == "attn":
                walk = _gqa_launch_walk(
                    pos, n_q, page_size, n_blocks, cfg.n_kv_heads,
                    cfg.n_heads // cfg.n_kv_heads, cfg.hd, isize, kv_isize,
                    quant, pipeline)
            elif b.mixer == "mla":
                walk = _mla_launch_walk(
                    pos, n_q, page_size, n_blocks, cfg.n_heads,
                    cfg.kv_lora_rank, cfg.rope_head_dim, isize, kv_isize,
                    quant)
            else:
                continue
            total += reps * walk
    return total


def crosscheck_vmem(engine, requests: Optional[List] = None,
                    n_q: int = 1, pipeline: Optional[str] = None) -> Dict:
    """Ledger <-> launch-grid cross-check for the on-chip level.

    No counter on the card reads L2-to-SM bytes here (no ``ncu``), so the
    check is pricing against artifact: the scheduler's closed-form
    ``attn_kernel_vmem_bytes`` against an independent walk of the CUDA
    kernels' launch grids (:func:`kernel_walk_vmem_bytes`), both for the
    kernel the engine dispatches to (``pipeline`` defaults to the
    engine's).  A ratio off 1.0 means the ledger's ``vmem`` bytes no
    longer describe the kernel that ships."""
    cfg, ps = engine.cfg, engine.ecfg.page_size
    if pipeline is None:
        pipeline = engine.ecfg.pipeline
    if requests is None:
        requests = engine._sched.decode_requests()
    if not requests:
        raise ValueError("no decoding requests to cross-check")
    contexts = [r.context_len for r in requests]
    n_blocks = engine._kv.blocks_per_slot
    analytic = sum(attn_kernel_vmem_bytes(cfg, L, ps, n_q=n_q,
                                          pipeline=pipeline)
                   for L in contexts)
    walked = sum(kernel_walk_vmem_bytes(cfg, L, ps, n_q=n_q,
                                        pipeline=pipeline, n_blocks=n_blocks)
                 for L in contexts)
    return {
        "analytic_vmem_bytes": analytic,
        "kernel_walk_bytes": walked,
        "vmem_ratio": analytic / max(walked, 1.0),
        "pipeline": pipeline,
        "contexts": contexts,
    }


# --------------------------------------------------------------------------
# The host level (swap), overlap
# --------------------------------------------------------------------------

def crosscheck_host(engine, n_blocks: Optional[int] = None) -> Dict:
    """Ledger <-> walk cross-check for the HOST level (swap copies).

    The swap phase charges ``slot_swap_bytes`` per preemption round trip.
    This walks the gather-and-pack ``PagedKVCache.swap_out`` runs
    (``gather_slot_pages`` of every pool leaf's pages and every state
    leaf's row, ``pack_leaves`` into the
    ONE flat buffer that crosses to the host) on fake tensors of the live
    pool shapes and compares its output bytes, the bytes that cross the
    link, against the pricing."""
    cfg, kv, e = _live(engine)
    if n_blocks is None:
        live = [kv.slot_pages(s) for s in range(e.num_slots)
                if s in kv._meta]
        n_blocks = max(live) if live else kv.pages_needed(kv.max_len)
    n_blocks = max(int(n_blocks), 1)

    def pack(pools, phys):
        return pack_leaves(tree_leaves(
            gather_slot_pages(pools, phys, kv._paged, 0)))[0]

    with _abstract() as fake:
        pools = tree_map(fake, kv.pools)
        paged, rows = split_leaves(pools, kv._paged)
        phys = torch.zeros((n_blocks,), dtype=torch.long)
        char = extract.characterize(pack, pools, phys, pools=paged,
                                    states=rows)
    out_bytes = float(char.memory.output_bytes)
    analytic = slot_swap_bytes(cfg, n_blocks, e.page_size)
    return {
        "analytic_swap_bytes": analytic,
        "hlo_output_bytes": out_bytes,
        "host_ratio": analytic / max(out_bytes, 1.0),
        "n_blocks": n_blocks,
    }


def overlapped_levels(ecfg) -> List[str]:
    """Memory levels an engine config claims to overlap: ``vmem`` when
    the paged kernels keep page tiles in flight (EngineConfig.pipeline !=
    "off"), ``ici`` when the tensor-parallel epilogues run as ring
    matmuls under their chunk products (EngineConfig.overlap != "none")."""
    out = []
    if ecfg.pipeline != "off":
        out.append("vmem")
    if ecfg.overlap != "none":
        out.append("ici")
    return out


# the reference's bar on analytic / walked collective bytes
ICI_RATIO_TOL = 1.15


def crosscheck_collectives(engine) -> Dict:
    """Ledger <-> walk cross-check of the communication roofline axis.

    A sharded engine (serve/shard.py) charges each decode step the
    analytic per-card wire bytes of ``scheduler.decode_step_ici_bytes``
    (one ring all-reduce per row-parallel epilogue, one tiled all-gather
    for an untied vocab-sharded head).  This runs one decode step on
    every rank under core/roofline/op_collectives.py's walk of the
    ``c10d`` operators it dispatches, prices them with the ring model and
    compares; the reference's bar is ``1 / 1.15 <= ici_ratio <= 1.15``.
    Every rank of the engine's mesh must call it together."""
    if getattr(engine, "mesh", None) is None:
        raise ValueError("engine has no tp > 1 mesh; build a "
                         "ShardedEngine(mesh_shape=(1, tp)) first")
    cfg, e = engine.cfg, engine.ecfg
    analytic = decode_step_ici_bytes(cfg, e.num_slots, engine.tp)
    walk = engine.walk_decode_collectives()
    return {
        "analytic_ici_bytes": analytic,
        "walk_ici_bytes": walk.ici_wire_bytes,
        "walk_dcn_bytes": walk.dcn_wire_bytes,
        "ici_ratio": analytic / max(walk.ici_wire_bytes, 1.0),
        "n_collective_ops": walk.n_ops,
        "by_kind": dict(walk.by_kind),
        "ops_by_kind": dict(walk.ops_by_kind),
        "collective_count_analytic": decode_collective_count(cfg),
        "tp": engine.tp,
    }


def crosscheck_overlap(engine_off, engine_on, prompts, gen, *,
                       windows: int = 3, wall_tol: float = 0.25,
                       term_tol: float = 1e-6, betas=None) -> Dict:
    """Measured <-> budget cross-check for the OVERLAP extension of the
    time-based roofline (core.roofline.model.overlapped_budget).

    Drives the SAME steady-state decode window (prefill outside,
    ``reset_phases``, pure decode steps, ``windows`` interleaved
    repetitions, min per-step wall) on two engines that differ ONLY in
    their overlap configuration: ``engine_off`` serial (pipeline="off"),
    ``engine_on`` with page tiles in flight (pipeline="double").  Raises
    unless

    * the greedy tokens are byte-identical (overlap is a schedule change,
      not a numerics change);
    * for every overlapped level the ledger's time term did not GROW
      beyond ``term_tol``;
    * the overlapped wall stays within ``wall_off * (1 + wall_tol)``.

    The measured wall delta is attributed back as an inferred per-level
    overlap fraction ``ov_l = clamp((wall_off - wall_on) / t_l, 0, 1)``.
    ``betas`` (a LevelBetas; default the on engine's chip) prices the
    terms: pass the card's measured ones to price ``vmem``."""
    from ..core.roofline.model import (LevelBetas, overlapped_budget,
                                       time_attribution)

    def steady(e):
        for p in prompts:
            e.submit(np.asarray(p) % e.cfg.vocab_size, gen)
        e.step()                      # prefill all slots + first tokens
        e.reset_phases()              # timed window: pure decode steps
        done = e.run()
        ph = e.phases["decode"]
        return ph.wall_s / max(ph.steps, 1), ph, done

    steady(engine_off)                # warm-up (graph capture), both
    steady(engine_on)
    walls_off, walls_on = [], []
    ph_off = ph_on = done_off = done_on = None
    for _ in range(windows):          # interleaved: noise hits both sides
        w0, ph_off, done_off = steady(engine_off)
        w1, ph_on, done_on = steady(engine_on)
        walls_off.append(w0)
        walls_on.append(w1)
    wall_off, wall_on = min(walls_off), min(walls_on)

    toks_off = [list(r.generated) for r in
                sorted(done_off, key=lambda r: r.request_id)]
    toks_on = [list(r.generated) for r in
               sorted(done_on, key=lambda r: r.request_id)]
    if toks_off != toks_on:
        raise RuntimeError(
            "overlap changed greedy outputs: the overlapped engine must "
            f"be byte-identical to the serial one ({toks_on} vs "
            f"{toks_off})")

    if betas is None:
        betas = LevelBetas.from_chip(engine_on.ecfg.chip,
                                     dtype=engine_on.cfg.dtype)
    # per-STEP terms, so they compare 1:1 with the per-step walls
    att_off = {k: v / max(ph_off.steps, 1)
               for k, v in time_attribution(ph_off, betas).items()}
    att_on = {k: v / max(ph_on.steps, 1)
              for k, v in time_attribution(ph_on, betas).items()}
    levels = overlapped_levels(engine_on.ecfg)
    for lvl in levels:
        if att_on[lvl] > att_off[lvl] * (1.0 + term_tol):
            raise RuntimeError(
                f"overlap grew the {lvl} time term: "
                f"{att_on[lvl]:.3e}s on vs {att_off[lvl]:.3e}s off: the "
                "overlapped kernel moves MORE bytes than the serial one it "
                "replaces")
    if wall_on > wall_off * (1.0 + wall_tol):
        raise RuntimeError(
            f"overlapped steady-state wall regressed: {wall_on * 1e6:.0f}"
            f"us/step vs serial {wall_off * 1e6:.0f}us/step exceeds "
            f"+{wall_tol:.0%} (raw per-window walls: "
            f"on={['%.0fus' % (w * 1e6) for w in walls_on]}, "
            f"off={['%.0fus' % (w * 1e6) for w in walls_off]})")

    delta = wall_off - wall_on            # per-step, like the terms
    inferred = {}
    for lvl in levels:
        t = att_off[lvl]
        inferred[lvl] = min(max(delta / t, 0.0), 1.0) if t > 0 else 0.0
    return {
        "wall_off_s": wall_off, "wall_on_s": wall_on,
        "walls_off_s": walls_off, "walls_on_s": walls_on,
        "levels": levels,
        "terms_off": att_off, "terms_on": att_on,
        "inferred_overlap": inferred,
        "serial_budget_s": sum(att_off.values()),
        "overlapped_budget_s": overlapped_budget(att_on, inferred),
        "generated": toks_on,
    }


# --------------------------------------------------------------------------
# The HBM-capacity axis
# --------------------------------------------------------------------------

def capacity_report(engine) -> Dict:
    """Page economics of ``engine``'s live block pool, with the reference's
    keys and meanings.  ``capacity_max_batch`` is the concurrency ceiling
    the chip's memory (``EngineConfig.chip.hbm_bytes``) implies at this
    engine's ``max_len``:

        B_max = (HBM - params_bytes) / (pages_per_request * page_bytes)

    ``effective_batch`` (requests holding a slot now) against it says
    whether the deployment is slot-limited or capacity-limited; every
    deduplicated or on-demand-deferred page moves B_max's denominator.

    A ``Cluster`` (serve/cluster.py) aggregates: a row per replica (each
    owns its pool, so pages in use and peak are per-replica facts) and
    fleet sums; B_max adds over replicas, each bringing its own memory."""
    if hasattr(engine, "replicas"):
        return _cluster_capacity_report(engine)
    if engine._kv is None:
        raise ValueError("engine has no live pool; submit work or reset()")
    kv, cfg, chip = engine._kv, engine.cfg, engine.ecfg.chip
    pool = kv.pool
    pb = kv.page_bytes
    pages_per_req = kv.pages_needed(kv.max_len)
    params_b = (param_counts(cfg)["total"]
                * torch_dtype(cfg.dtype).itemsize)
    hbm_for_kv = max(chip.hbm_bytes - params_b, 0.0)
    cap_batch = int(hbm_for_kv // max(pages_per_req * pb, 1))
    active = list(engine._sched.active.values()) if engine._sched else []
    return {
        "page_bytes": pb,
        "pages_total": kv.num_pages - 1,            # minus the trash page
        "pages_in_use": pool.pages_in_use,
        "pages_peak": pool.stats.peak_in_use,
        "pages_cached": pool.pages_cached,
        "pages_deduped": pool.stats.dedup_hits,
        "cow_copies": pool.stats.cow_copies,
        "evictions": pool.stats.evictions,
        "preemptions": engine._sched.preempt_count if engine._sched else 0,
        "pool_bytes": pb * (kv.num_pages - 1),
        "params_bytes": float(params_b),
        "pages_per_request": pages_per_req,
        "effective_batch": len(active),
        "capacity_max_batch": cap_batch,
    }


_CAP_SUM_KEYS = ("pages_total", "pages_in_use", "pages_peak", "pages_cached",
                 "pages_deduped", "cow_copies", "evictions", "preemptions",
                 "pool_bytes", "effective_batch", "capacity_max_batch")


def _cluster_capacity_report(cluster) -> Dict:
    """The fleet's capacity: one row per replica (role-tagged), sums on the
    page and batch axes over the replicas with a live pool
    (``replicas_live``; a replica that never received work has none)."""
    per = []
    for i, eng in enumerate(cluster.replicas):
        row: Dict = {"replica": i, "role": cluster.role(i)}
        if eng._kv is None:
            row["live"] = False
        else:
            row.update(capacity_report(eng))
            row["live"] = True
        per.append(row)
    live = [r for r in per if r["live"]]
    if not live:
        raise ValueError("no replica has a live pool; route work through "
                         "the Router (or engine.reset()) first")
    out: Dict = {k: sum(r[k] for r in live) for k in _CAP_SUM_KEYS}
    # the same on every replica (one cfg and ecfg)
    for k in ("page_bytes", "params_bytes", "pages_per_request"):
        out[k] = live[0][k]
    agg = cluster.aggregate_ledger()
    out.update(replicas=per, replicas_live=len(live),
               migrations=int(agg.migrations),
               migration_bytes=float(agg.migration_bytes))
    return out
