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

Data parallelism (an active mesh with data-parallel axes,
``parallel.mesh.dp_axes``: train/step.py's data-parallel step) gives a
rank its shard of the batch's tokens, and every value is the global
batch's, as under the reference's GSPMD:

* the global dispatch takes its capacity from the global token count.
  The reference's stable sort makes a pair's slot its position among its
  expert's pairs in global token order; here each rank all-gathers the
  shards' per-expert pair counts, takes the exclusive prefix over the
  shards before its own, and keeps a pair while that prefix plus its
  local position is below C.  Each rank then computes only its own kept
  pairs, in a buffer as deep as its largest expert's kept count (a host
  read), where the reference spreads the C slots over ``data``: another
  placement, the same kept pairs and outputs;
* the data-local dispatch (``moe_dispatch="local"``) groups tokens by
  their data-parallel shard, each group's capacity from its own token
  count: a rank's tokens are its one group, so the global dispatch over
  them is the local one, mesh or none;
* the aux loss's ``me`` and ``ce`` are means over the global batch: the
  router probabilities' sum goes through ``collectives.psum``, whose
  backward makes the ranks' mean gradient the global one, and the pair
  counts are the gathered shards'.

Tensor parallelism (``cfg.tp_axis``, training's rules): ``experts``
lands on the axis (a rank holds E/tp of them; where E does not divide
it, every expert's ``d_ff`` is split instead), and the shared experts'
``d_ff`` is split as a dense FFN's.  The tokens are replicated across
the axis, so the router, the top-k, the capacity ranks, the kept pairs
and the aux are computed over all E experts on every rank, as on one;
each rank runs the products of its own experts' slots, and its combine
and shared output are partial sums that one ``tp_reduce`` finishes.
The tokens enter the experts through ``tp_copy``, and so do the gates
(the gradient of a gate reaches only the rank holding its expert's
output; the router's own path, aux included, is whole on every rank).

:func:`record_dispatch` logs each call's kept (token, expert) pairs by
global token index.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from ..core.roofline.op_cost import named_scope
from ..parallel.collectives import tp_copy, tp_reduce
from ..parallel.mesh import active_mesh, batch_shard, dp_axes
from .common import ModelConfig, round_up
from .layers import activate, is_glu, mlp_defs, mlp_partial
from .params import ParamDef

_LOG: Dict[str, Optional[List[Dict[str, torch.Tensor]]]] = {"calls": None}


@contextlib.contextmanager
def record_dispatch():
    """Collect every MoE call's kept pairs while inside: yields a list
    that gets one dict a call, ``{"token": (P,) int64 global token index,
    "expert": (P,) int64, "choice": (N, K) the call's tokens' chosen
    experts, "capacity": C}`` (a checkpointed layer's recompute in
    backward logs again)."""
    prev, _LOG["calls"] = _LOG["calls"], []
    try:
        yield _LOG["calls"]
    finally:
        _LOG["calls"] = prev


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
                      eids: torch.Tensor, C: int, cfg: ModelConfig, *,
                      offset: Optional[torch.Tensor] = None,
                      depth: Optional[int] = None,
                      experts: Optional[Tuple[int, int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch for one token group.

    xf (N, D); gates/eids (N, K).  Returns (xe (El,Cb,D), slot_token
    (E*Cb,) int32, slot_gate (E*Cb,) float32) with N as the pad sentinel:
    the slot table of every expert, the buffer of the ``experts`` range
    (first, El) only (all E when None; a tensor-parallel rank's own).
    ``offset`` (E,) int32: the pairs of each expert that come before this
    group's in the global order (the data-parallel dispatch; zeros when
    None), so a pair is kept while offset + its rank is below C; ``depth``
    Cb (C when None): the buffer's slots an expert, at least every
    expert's kept count here."""
    N, D = xf.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    Cb = C if depth is None else depth
    dev = xf.device
    flat_e = eids.reshape(-1).to(torch.int32)                # (N*K,)
    order = torch.argsort(flat_e, stable=True)               # (N*K,)
    sorted_e = flat_e[order]
    first_idx = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=torch.int32, device=dev),
        side="left", out_int32=True)                         # (E,)
    rank = (torch.arange(N * K, dtype=torch.int32, device=dev)
            - first_idx[sorted_e.long()])
    slot = sorted_e * Cb + rank                              # (N*K,)
    keep = rank < C if offset is None else (
        rank + offset[sorted_e.long()] < C)
    # pairs past capacity go to the spare row E*Cb, cut off below
    dest = torch.where(keep, slot, E * Cb).long()
    slot_token = torch.full((E * Cb + 1,), N, dtype=torch.int32,
                            device=dev)
    slot_token[dest] = (order // K).to(torch.int32)
    slot_gate = torch.zeros((E * Cb + 1,), dtype=torch.float32, device=dev)
    slot_gate[dest] = gates.reshape(-1)[order].float()
    slot_token, slot_gate = slot_token[:E * Cb], slot_gate[:E * Cb]
    e0, El = experts or (0, E)
    xpad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    xe = xpad[slot_token[e0 * Cb:(e0 + El) * Cb].long()].reshape(El, Cb, D)
    return xe, slot_token, slot_gate


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux load-balance loss ())."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    N = B * S
    xf = x.reshape(N, D)
    mesh = active_mesh()
    axes = dp_axes(mesh)
    tp = cfg.tp_axis

    logits = xf.float() @ p["router"]                        # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, K, dim=-1)               # (N, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # aux load-balance loss (Switch eq. 4), over the global batch
    counts = torch.zeros((E,), dtype=torch.float32,
                         device=x.device).index_add_(
        0, eids.reshape(-1),
        torch.ones((N * K,), dtype=torch.float32, device=x.device))
    if axes:
        from ..parallel.collectives import gather_shards, psum
        with named_scope("moe_dispatch"):
            shard_counts = gather_shards(counts, axes)       # (R, E)
        R, shard = shard_counts.shape[0], batch_shard(mesh)
        me = psum(probs.sum(0), axes) / (N * R)
        ce = shard_counts.sum(0) / (N * R * K)
    else:
        R, shard = 1, 0
        me = probs.mean(0)                                   # (E,)
        ce = counts / (N * K)
    aux = E * (me * ce).sum() * cfg.router_aux_coef

    # the experts' inputs, replicated, enter this rank's products
    xd, gd = tp_copy(xf, tp), tp_copy(gates, tp)
    if R > 1 and cfg.moe_dispatch != "local":
        C = _capacity(N * R, cfg)
        offset = shard_counts[:shard].sum(0).to(torch.int32)
        kept = torch.clamp(torch.minimum(C - offset, counts.to(torch.int32)),
                           min=0)
        out = _moe_global(p, xd, gd, eids, C, cfg, offset=offset,
                          depth=_depth(kept, C), shard=shard)
    else:
        # "local", or one shard: this rank's tokens are its one group
        out = _moe_global(p, xd, gd, eids, _capacity(N, cfg), cfg,
                          shard=shard)
    if cfg.n_shared_experts:
        out = out + mlp_partial(p["shared"], xd, cfg)
    return tp_reduce(out, tp).reshape(B, S, D), aux


def _depth(kept: torch.Tensor, C: int) -> int:
    """The slots an expert of this rank's buffer: its largest expert's
    kept count (read on the host) rounded up to 8, at most C; C itself
    while walking fake tensors, which hold no counts."""
    from torch._subclasses.fake_tensor import FakeTensor
    if isinstance(kept, FakeTensor):
        return C
    return min(round_up(max(int(kept.max()), 1), 8), C)


def _expert_glu(p, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-expert FFN over the (E, C, D) buffer -> (E, C, D)."""
    h = torch.bmm(xe, p["w_up"])
    g = torch.bmm(xe, p["w_gate"]) if "w_gate" in p else None
    return torch.bmm(activate(h, g, cfg.act), p["w_down"])


def _moe_global(p, xf: torch.Tensor, gates: torch.Tensor,
                eids: torch.Tensor, C: int, cfg: ModelConfig, *,
                offset: Optional[torch.Tensor] = None,
                depth: Optional[int] = None, shard: int = 0
                ) -> torch.Tensor:
    """One slot table: dispatch, expert products, gated combine
    (``offset`` / ``depth``: :func:`_dispatch_combine`'s; ``shard``
    places the tokens in the global order for :func:`record_dispatch`).
    The products and the combine cover this rank's experts (all of them
    unless ``experts`` is sharded over ``cfg.tp_axis``): a partial sum
    under tensor parallelism."""
    N, D = xf.shape
    El = p["w_up"].shape[0]
    e0 = 0 if El == cfg.n_experts else \
        active_mesh().coord(cfg.tp_axis) * El
    with named_scope("moe_dispatch"):
        xe, slot_token, slot_gate = _dispatch_combine(
            xf, gates, eids, C, cfg, offset=offset, depth=depth,
            experts=(e0, El))
    Cb = xe.shape[1]
    if _LOG["calls"] is not None:
        full = (slot_token < N).nonzero()[:, 0]
        _LOG["calls"].append({
            "token": slot_token[full].long() + shard * N,
            "expert": full // Cb, "choice": eids.detach().clone(),
            "capacity": C})
    with named_scope("moe_experts"):
        ye = _expert_glu(p, xe, cfg)
    with named_scope("moe_dispatch"):
        mine = slice(e0 * Cb, (e0 + El) * Cb)
        yflat = ye.reshape(El * Cb, D) * slot_gate[mine, None].to(ye.dtype)
        out = torch.zeros((N + 1, D), dtype=ye.dtype, device=xf.device)
        out.index_add_(0, slot_token[mine].long(), yflat)
    return out[:N]
