"""Kernel-substitution modeling: what the roofline becomes when a tagged
plain-PyTorch region is replaced by its hand-written kernel.  A copy of
the JAX package's ``core/roofline/substitute.py`` (pure arithmetic), with
``substitute_flash`` priced on the port's ``H100_SXM``.

The op-level walk (``op_cost.py``) of the *plain* attention materializes
the (B,H,Sq,Sk) score tensor in memory, visible as the
``fused_attention`` scope's bytes.  On the card that region runs as the
flash-attention kernel (``csrc/flash_attention.cu``): scores stay on the
chip, memory traffic is q/k/v/o only.  Rather than hand-waving, the
substitution is computed from the scope's own measured FLOPs and a
conservative kernel arithmetic intensity:

    AI_flash(causal, bq=128) ~= S / 64   [FLOP per HBM byte]

Derivation: per head, flops ~= 2*hd*S^2 (causal half); HBM traffic
~= S*hd*(q + o) + (S/bq)*S*hd*(k+v re-reads) elems * 2 B
~= 2*S*hd*(1 + S/bq) B  ->  AI = S/(2*(1+S/bq)) ~ S/66 for bq=128.
This *undercounts* the win (a production kernel pins K/V slabs across q
blocks), so the substituted numbers are a lower bound on the kernel's
benefit.  The same mechanism prices any TRACKED_SCOPES region.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

from .hardware import H100_SXM, ChipSpec


def flash_attention_ai(seq_len: int, bq: int = 128) -> float:
    return seq_len / (2.0 * (1.0 + seq_len / bq))


def paged_attention_kernel_bytes(context_lens, kv_line_bytes: float,
                                 qo_bytes_per_slot: float = 0.0,
                                 n_q: int = 1) -> float:
    """HBM bytes of ONE paged-decode attention step under the paged kernel
    (kernels/paged_attention.py): each slot streams its live KV pages
    from memory exactly once — for ``n_q = 1`` that is (L_i + 1) cache lines
    counting the just-written token — plus its q/o vectors.  This is the
    same expression the scheduler's analytic ledger charges
    (scheduler.decode_token_bytes KV term), which is what lets the ledger
    and the walk's cross-check agree once the plain version's gather
    traffic is swapped out.

    ``n_q > 1`` prices the multi-token *verification* kernel of the
    speculative subsystem (kernels ``paged_attention_verify``): ``n_q``
    lines are written and ONE shared page walk reads the context plus the
    just-written draft lines — (L_i + 2 * n_q - 1) lines total, matching
    RooflineLedger.add_verify_step.  The walk is shared across all n_q
    query tokens, which is exactly why verification raises intensity.

    ``context_lens``: iterable of per-slot context lengths L_i;
    ``kv_line_bytes``: all-layer cache line (scheduler.kv_line_bytes —
    for quantized pools this is already the SHRUNK line: storage-itemsize
    values plus per-line f32 scales, so the substitution prices the
    quantized page walk with no extra plumbing);
    ``qo_bytes_per_slot``: per-slot q + o vector traffic (optional).
    """
    total = 0.0
    for L in context_lens:
        total += (L + 2 * n_q - 1) * kv_line_bytes + qo_bytes_per_slot
    return total


def substitute_paged_attention(char_dict: Dict, context_lens,
                               kv_line_bytes: float,
                               qo_bytes_per_slot: float = 0.0,
                               n_q: int = 1) -> Optional[Dict]:
    """Return a copy of a ``character_as_dict`` dump with the
    ``paged_attention`` scope's bytes replaced by the kernel's (the plain
    version materializes the gathered (B, S, KV, hd) K/V in memory —
    roughly 2x the live pages per step — which the kernel never does).
    ``n_q`` > 1 prices the multi-token verification kernel.
    None if the dump has no paged-attention scope."""
    scope = (char_dict.get("scopes") or {}).get("paged_attention")
    if not scope:
        return None
    out = copy.deepcopy(char_dict)
    new_bytes = paged_attention_kernel_bytes(context_lens, kv_line_bytes,
                                             qo_bytes_per_slot, n_q=n_q)
    out["hbm_bytes_dev"] = max(
        char_dict["hbm_bytes_dev"] - scope["bytes"] + new_bytes, 1.0)
    out["scopes"]["paged_attention"] = {"flops": scope["flops"],
                                        "bytes": new_bytes}
    out["variant"] = (char_dict.get("variant", "baseline")
                      + "+paged_attention(modeled)")
    return out


def substitute_flash(cell: Dict, seq_len: int,
                     chip: ChipSpec = H100_SXM) -> Optional[Dict]:
    """Return a copy of a dry-run cell dict with the fused_attention scope's
    HBM bytes replaced by the flash-kernel equivalent.  None if the cell has
    no attention scope."""
    scope = (cell.get("scopes") or {}).get("fused_attention")
    if not scope or not scope.get("flops"):
        return None
    out = copy.deepcopy(cell)
    ai = flash_attention_ai(seq_len)
    new_attn_bytes = scope["flops"] / ai
    old_bytes = cell["hbm_bytes_dev"]
    new_bytes = max(old_bytes - scope["bytes"] + new_attn_bytes, 1.0)
    out["hbm_bytes_dev"] = new_bytes
    out["memory_s"] = new_bytes / chip.hbm_bw
    terms = {"compute": out["compute_s"], "memory": out["memory_s"],
             "ici": out["ici_s"], "dcn": out["dcn_s"]}
    out["dominant"] = max(terms, key=terms.get)
    out["t_lower_s"] = max(terms.values())
    out["t_upper_s"] = sum(terms.values())
    out["arithmetic_intensity"] = out["flops_dev"] / new_bytes
    if out.get("model_flops_total"):
        useful_s = (out["model_flops_total"] / out["n_chips"]
                    / chip.flops_for(out.get("dtype", "bfloat16")))
        out["roofline_fraction"] = useful_s / out["t_lower_s"]
    out["variant"] = (cell.get("variant", "baseline") + "+flash(modeled)")
    out["scopes"]["fused_attention"] = {"flops": scope["flops"],
                                        "bytes": new_attn_bytes}
    return out
