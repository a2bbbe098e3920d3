"""Mixture-of-Experts FFN with sort-based capacity dispatch: the JAX
package's ``models/moe.py`` (global dispatch) in PyTorch.

1. router (float32) -> softmax -> top-k expert ids and gates per token,
   gates renormalised over the k chosen;
2. flatten the (token, choice) pairs and sort them by expert id, stably;
3. rank within expert by index arithmetic on the sorted ids;
4. scatter token indices into a fixed (E, C) slot table — C is the
   capacity, and pairs ranked past it drop (GShard semantics: earlier
   tokens win);
5. gather tokens into the (E, C, D) expert buffer;
6. batched expert GLU products (``torch.bmm`` over all E experts);
7. scatter-add back with the gate weights, plus the shared experts.

Every step keeps the reference's semantics exactly, since one (token,
expert) pair dropped differently flips tokens downstream: the sort is
stable like ``jnp.argsort``, the out-of-range "drop" index E*C lands in
one spare row that is cut off, and the combine scatter-adds into an
(N+1, D) buffer whose last row is the pad sentinel.  At decode the
expert products read every expert's weights, as the reference's do.

The data-local dispatch (``moe_dispatch="local"``) groups tokens by
their data-parallel shard, each group's capacity from its own token
count.  Under the port's explicit SPMD a rank holds only its own shard's
tokens, so its tokens are its one group and the global dispatch over
them is the local one.  The aux loss is the reference's formula over the
tokens the call sees: a rank's, where the reference's is over the global
batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.roofline.op_cost import named_scope
from .common import ModelConfig, round_up
from .layers import activate, apply_mlp, is_glu, mlp_defs
from .params import ParamDef


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = cfg.dtype
    defs: Dict[str, ParamDef] = {
        "router": ParamDef((D, E), "float32", logical=("d_model", "none")),
        "w_up": ParamDef((E, D, F), dt, fan_in_axes=(1,),
                         logical=("experts", "d_model", "d_ff")),
        "w_down": ParamDef((E, F, D), dt, fan_in_axes=(1,),
                           logical=("experts", "d_ff", "d_model")),
    }
    if is_glu(cfg.act):
        defs["w_gate"] = ParamDef((E, D, F), dt, fan_in_axes=(1,),
                                  logical=("experts", "d_model", "d_ff"))
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(cfg,
                                  d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return defs


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    # the reference rounds to a multiple of 128 at >= 4096 tokens (so the
    # capacity dim divides its data axis); kept for identical drops
    return max(round_up(c, 128), 128) if n_tokens >= 4096 else max(
        round_up(c, 8), 8)


def _dispatch_combine(xf: torch.Tensor, gates: torch.Tensor,
                      eids: torch.Tensor, C: int, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch for one token group.

    xf (N, D); gates/eids (N, K).  Returns (xe (E,C,D), slot_token (E*C,)
    int32, slot_gate (E*C,) float32) with N as the pad sentinel."""
    N, D = xf.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    dev = xf.device
    flat_e = eids.reshape(-1).to(torch.int32)                # (N*K,)
    order = torch.argsort(flat_e, stable=True)               # (N*K,)
    sorted_e = flat_e[order]
    first_idx = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=torch.int32, device=dev),
        side="left", out_int32=True)                         # (E,)
    rank = (torch.arange(N * K, dtype=torch.int32, device=dev)
            - first_idx[sorted_e.long()])
    slot = sorted_e * C + rank                               # (N*K,)
    # pairs past capacity go to the spare row E*C, cut off below
    dest = torch.where(rank < C, slot, E * C).long()
    slot_token = torch.full((E * C + 1,), N, dtype=torch.int32, device=dev)
    slot_token[dest] = (order // K).to(torch.int32)
    slot_gate = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    slot_gate[dest] = gates.reshape(-1)[order].float()
    slot_token, slot_gate = slot_token[:E * C], slot_gate[:E * C]
    xpad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    xe = xpad[slot_token.long()].reshape(E, C, D)
    return xe, slot_token, slot_gate


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux load-balance loss ())."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    N = B * S
    C = _capacity(N, cfg)
    xf = x.reshape(N, D)

    logits = xf.float() @ p["router"]                        # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, K, dim=-1)               # (N, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # aux load-balance loss (Switch eq. 4)
    me = probs.mean(0)                                       # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, eids.reshape(-1),
        torch.ones((N * K,), dtype=torch.float32, device=x.device)) / (N * K)
    aux = E * (me * ce).sum() * cfg.router_aux_coef

    # "local": a rank's tokens are its one group, so C is the group's.
    out = _moe_global(p, xf, gates, eids, C, cfg)
    if cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], xf, cfg)
    return out.reshape(B, S, D), aux


def _expert_glu(p, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-expert FFN over the (E, C, D) buffer -> (E, C, D)."""
    h = torch.bmm(xe, p["w_up"])
    g = torch.bmm(xe, p["w_gate"]) if "w_gate" in p else None
    return torch.bmm(activate(h, g, cfg.act), p["w_down"])


def _moe_global(p, xf: torch.Tensor, gates: torch.Tensor,
                eids: torch.Tensor, C: int, cfg: ModelConfig
                ) -> torch.Tensor:
    """One global slot table: dispatch, expert products, gated combine."""
    N, D = xf.shape
    E = cfg.n_experts
    with named_scope("moe_dispatch"):
        xe, slot_token, slot_gate = _dispatch_combine(xf, gates, eids, C,
                                                      cfg)
    with named_scope("moe_experts"):
        ye = _expert_glu(p, xe, cfg)
    with named_scope("moe_dispatch"):
        yflat = ye.reshape(E * C, D) * slot_gate[:, None].to(ye.dtype)
        out = torch.zeros((N + 1, D), dtype=ye.dtype, device=xf.device)
        out.index_add_(0, slot_token.long(), yflat)
    return out[:N]
