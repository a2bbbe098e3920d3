"""AdamW with global-norm clipping and LR schedules (cosine, MiniCPM's
WSD, constant): the JAX package's ``train/optimizer.py`` in PyTorch.

The update is functional, as the reference's: it returns new parameter
and moment tensors and leaves its inputs alone.  Moments are float32
whatever the parameter dtype; each parameter is updated in float32 and
cast back to its dtype.  The schedule is computed in float32 tensors on
the step counter's device, so the learning rate is the reference's
float32 value and no step waits on the host.

ZeRO-1: :func:`zero1_spec` gives each moment its parameter's spec plus
the ``data`` axis on the largest still-unsharded divisible dim, so
optimizer state is partitioned across data-parallel replicas
(:func:`moment_shards`: a rank's block of each moment).  On a mesh
(:func:`adamw_update_dp`) each rank reduce-scatters its gradients along
each moment's data dim (an all-reduce where a moment is replicated),
all-reduces over ``pod``, whose ranks hold replicas as in the reference,
clips by the global norm, updates its shard and all-gathers the
parameters.  Under a ``model`` axis too, a parameter is this rank's
model block (its spec's) and ZeRO-1 cuts that block again along the
moment's data dim: the reduce-scatter and all-gather run over ``data``
inside the rank's model shard, and the norm's squares of a
model-sharded leaf are summed over ``model``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch

from ..models.model import drop_cast
from ..models.params import tree_leaves, tree_map, tree_unflatten
from ..parallel import collectives as coll
from ..parallel import sharding as shd
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, POD_AXIS, dp_axes,
                             mesh_axis_sizes)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"           # cosine | wsd | constant
    wsd_decay_frac: float = 0.1        # MiniCPM: last 10% decays
    min_lr_ratio: float = 0.1


def lr_at(step: Union[int, torch.Tensor], oc: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a 0-d
    float32 tensor on the step's device: linear warmup times the
    schedule's fraction."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(oc.warmup_steps, 1), max=1.0)
    if oc.schedule == "constant":
        frac = torch.ones_like(s)
    elif oc.schedule == "wsd":
        # warmup -> stable -> decay (MiniCPM, arXiv:2404.06395 §4)
        decay_start = oc.total_steps * (1.0 - oc.wsd_decay_frac)
        t = torch.clamp((s - decay_start) / max(
            oc.total_steps - decay_start, 1.0), 0.0, 1.0)
        frac = 1.0 - (1.0 - oc.min_lr_ratio) * t
    elif oc.schedule == "cosine":
        t = torch.clamp((s - oc.warmup_steps) / max(
            oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
        frac = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
    else:
        raise ValueError(f"unknown schedule {oc.schedule!r}")
    return oc.lr * warm * frac


def moment_shards(param_defs, mesh):
    """A tree of ``param_defs``' structure: each moment's
    ``parallel.sharding.Block`` on this rank of ``mesh`` under its
    :func:`zero1_spec` (the parameter's ``model`` pieces, then the
    ``data`` piece), or None where the moment is whole on every rank.
    The block's ``data`` piece (``Block.on``) cuts the rank's parameter
    block: ``zero1_spec`` never puts ``data`` on a model-sharded dim, so
    that dim's size is the whole leaf's; a ``model`` piece says the
    parameter itself is this rank's block."""
    return tree_map(lambda d: shd.leaf_block(zero1_spec(d, mesh), mesh),
                    param_defs)


def _data_piece(blk):
    """The ``data`` piece of a moment's block (None when it has none)."""
    return None if blk is None else blk.on(DATA_AXIS)


def init_opt_state(params, shards=None) -> Dict[str, Any]:
    """Zero float32 moments beside each parameter (the tied embedding's
    cached cast is no parameter: ``models.drop_cast``), each the ``data``
    piece of its block under ``shards`` (:func:`moment_shards`; whole
    when None) of the rank's parameter block, and the step counter (a
    0-d int32 tensor), on the parameters' device."""
    params = drop_cast(params)
    leaves = tree_leaves(params)
    if shards is None:
        shards = tree_map(lambda x: None, params)
    zeros = lambda: tree_map(                                   # noqa: E731
        lambda x, sh: torch.zeros(
            x.shape if _data_piece(sh) is None else _data_piece(sh).shape(
                x.shape), dtype=torch.float32, device=x.device),
        params, shards)
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf (the leaves'
    sums added in leaf order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, opt_state, oc: OptConfig):
    """Returns (new_params, new_opt_state, {"grad_norm", "lr"}).

    Gradients are clipped to ``oc.clip_norm`` by their global norm;
    bias-corrected moments; decoupled weight decay on leaves of rank 2
    or more only; each parameter updated in float32 and cast back to its
    dtype."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    upd, lr = _adamw_leaf(step, gnorm, oc)
    out = [upd(*a) for a in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"]))]
    new_p, new_mu, new_nu = (tree_unflatten(params, [o[i] for o in out])
                             for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, {
        "grad_norm": gnorm, "lr": lr}


def _adamw_leaf(step: torch.Tensor, gnorm: torch.Tensor, oc: OptConfig):
    """(the update of one leaf ``(p, g, mu, nu) -> (p, mu, nu)`` at
    ``step`` with the gradients clipped by ``gnorm``, the learning
    rate)."""
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(step, oc)
    b1, b2 = oc.betas
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=sf.device), sf)

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        delta = (mu / c1) / (torch.sqrt(nu / c2) + oc.eps)
        pf = p.float()
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            delta = delta + oc.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), mu, nu

    return upd, lr


@torch.no_grad()
def adamw_update_dp(params, grads, opt_state, oc: OptConfig, shards,
                    mesh):
    """:func:`adamw_update` on a data-parallel mesh, ZeRO-1: ``grads``
    are this rank's (its shard of the batch, in the dtype the reduce
    runs in), ``opt_state`` holds this rank's moment blocks under
    ``shards`` (:func:`moment_shards`), on ``mesh``'s batch axes with a
    group (``parallel.mesh.dp_axes``; the collectives find the groups in
    the active mesh).  Per leaf: the gradient's sum over
    ``data``, reduce-scattered to the moment's block (all-reduced whole
    where the moment is replicated), then over ``pod`` on that block,
    divided by the shard count: the mean gradient, in the gradient's
    dtype.  The clip takes the global norm: every leaf's float32 sum of
    squares, a sharded leaf's from its blocks, all-reduced over ``data``
    in one vector and added in leaf order (with one data rank, bit for
    bit :func:`global_norm`).  Each rank updates its blocks, and the
    parameters are all-gathered along the moments' dims.  On a mesh with
    a ``model`` group, a leaf whose block has a ``model`` piece is this
    rank's model block: its squares are partial sums, added over
    ``model`` with the vector; a leaf replicated over ``model`` counts
    once.  ``shards`` None: every leaf whole.  Returns
    :func:`adamw_update`'s triple."""
    axes = dp_axes(mesh)
    data = DATA_AXIS in axes
    pod = POD_AXIS in axes
    model = MODEL_AXIS in mesh.groups
    shards_n = 1
    for a in axes:
        shards_n *= mesh.sizes[a]
    lead = (mesh.coord(DATA_AXIS) == 0) if data else True
    lead_m = (mesh.coord(MODEL_AXIS) == 0) if model else True
    if shards is None:
        shards = tree_map(lambda x: None, params)
    blocks = tree_leaves(shards)
    p_l, s_l = tree_leaves(params), [_data_piece(b) for b in blocks]
    reduced, sq = [], []
    for g, sh, blk in zip(tree_leaves(grads), s_l, blocks):
        if data:
            g = (coll.all_reduce_(g.clone(), (DATA_AXIS,)) if sh is None
                 else coll.reduce_scatter_dim(g, sh.dim, DATA_AXIS))
        if pod:
            g = coll.all_reduce_(g.contiguous(), (POD_AXIS,))
        g = g / shards_n
        reduced.append(g)
        s = torch.sum(torch.square(g.float()))
        ms = blk is not None and blk.on(MODEL_AXIS) is not None
        once = (sh is not None or lead) and (ms or lead_m)
        sq.append(s if once else torch.zeros_like(s))
    sq = torch.stack(sq)
    if data:
        coll.all_reduce_(sq, (DATA_AXIS,))
    if model:
        coll.all_reduce_(sq, (MODEL_AXIS,))
    gnorm = torch.sqrt(sum(sq.unbind(0)))
    step = opt_state["step"] + 1
    upd, lr = _adamw_leaf(step, gnorm, oc)
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu, sh in zip(p_l, reduced, tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"]), s_l):
        q, mu, nu = upd(p if sh is None else sh.take(p), g, mu, nu)
        if sh is not None:
            q = coll.all_gather_dim(q, sh.dim, DATA_AXIS)
        new_p.append(q)
        new_mu.append(mu)
        new_nu.append(nu)
    tree = lambda leaves: tree_unflatten(params, leaves)       # noqa: E731
    return tree(new_p), {"mu": tree(new_mu), "nu": tree(new_nu),
                         "step": step}, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------
# ZeRO-1 specs for the moments
# --------------------------------------------------------------------------

def zero1_spec(d: shd.ParamDef, mesh, rules: shd.ShardingRules = shd.DEFAULT
               ) -> shd.Spec:
    """The parameter's own spec plus ``data`` on its largest unsharded
    dim that the data axis divides."""
    sizes = mesh_axis_sizes(mesh)
    base = shd.resolve_spec(d.logical, d.shape, sizes, rules)
    data = sizes.get("data", 1)
    if data <= 1:
        return base
    entries = list(base) + [None] * (len(d.shape) - len(base))
    used = set()
    for e in entries:
        if e is not None:
            used.update(e if isinstance(e, tuple) else (e,))
    if "data" in used:
        return base
    order = sorted(range(len(d.shape)), key=lambda i: -d.shape[i])
    for i in order:
        if entries[i] is None and d.shape[i] % data == 0 \
                and d.shape[i] >= data:
            entries[i] = "data"
            break
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def opt_state_shardings(param_defs, mesh,
                        rules: shd.ShardingRules = shd.DEFAULT):
    """Spec trees of the optimizer state: ZeRO-1 moments, a replicated
    step counter."""
    moment = tree_map(lambda d: zero1_spec(d, mesh, rules), param_defs)
    return {"mu": moment, "nu": moment, "step": ()}


def abstract_opt_state(param_defs, shards=None):
    """The optimizer state as meta tensors (shapes and dtypes only), the
    moments this rank's blocks under ``shards`` (:func:`moment_shards`;
    whole when None) of the whole leaves ``param_defs`` gives."""
    if shards is None:
        shards = tree_map(lambda d: None, param_defs)
    mom = lambda: tree_map(                                     # noqa: E731
        lambda d, sh: torch.empty(d.shape if sh is None else sh.shape(
            d.shape), dtype=torch.float32, device="meta"),
        param_defs, shards)
    return {"mu": mom(), "nu": mom(),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
