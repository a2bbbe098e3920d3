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
optimizer state would be partitioned across data-parallel replicas.  The
port keeps it as spec trees over ``parallel/sharding.py``; data-parallel
execution (the gradient all-reduce and the moments sharded by these
specs) is ROADMAP queue 1 item 19.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch

from ..models.model import drop_cast
from ..models.params import tree_leaves, tree_map, tree_unflatten
from ..parallel import sharding as shd
from ..parallel.mesh import mesh_axis_sizes


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


def init_opt_state(params) -> Dict[str, Any]:
    """Zero float32 moments beside each parameter (the tied embedding's
    cached cast is no parameter: ``models.drop_cast``), and the step
    counter (a 0-d int32 tensor), on the parameters' device."""
    params = drop_cast(params)
    leaves = tree_leaves(params)
    zeros = lambda t: tree_map(                                 # noqa: E731
        lambda x: torch.zeros(x.shape, dtype=torch.float32,
                              device=x.device), t)
    return {"mu": zeros(params), "nu": zeros(params),
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

    out = [upd(*a) for a in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"]))]
    new_p, new_mu, new_nu = (tree_unflatten(params, [o[i] for o in out])
                             for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, {
        "grad_norm": gnorm, "lr": lr}


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


def abstract_opt_state(param_defs):
    """The optimizer state as meta tensors (shapes and dtypes only)."""
    mom = lambda: tree_map(                                     # noqa: E731
        lambda d: torch.empty(d.shape, dtype=torch.float32, device="meta"),
        param_defs)
    return {"mu": mom(), "nu": mom(),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
