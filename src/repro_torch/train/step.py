"""The train step: loss -> grads -> clip -> AdamW, with optional
gradient-accumulation microbatching and bf16 gradient compression: the
JAX package's ``train/step.py`` in PyTorch.

``make_train_step`` returns a function ``(state, batch) -> (state,
metrics)`` with state ``{"params", "opt"}``.  It is functional, as the
reference's jitted step is: the gradients are taken with
``torch.autograd.grad`` against detached copies of the parameter leaves,
and the update returns new tensors.

The tied embedding's cached cast (``embed["tok_cast"]``, attached by
``models.prepare_params`` for serving) is left out of training: the step
drops it before the forward, so the logits cast ``tok`` per call and the
gradient reaches ``tok``; the returned parameters carry none, so the
optimizer never counts it and a checkpoint never holds it, and a serve
engine built on the trained parameters casts the updated table afresh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..models import drop_cast, loss_fn
from ..models.common import ModelConfig
from ..models.params import tree_leaves, tree_map, tree_unflatten
from .optimizer import OptConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    grad_accum: int = 1              # microbatch steps per update


def value_and_grad(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, {"nll", "aux"}, grads) of :func:`models.loss_fn` at
    ``params``: grads a tree of ``params``' structure in the leaves'
    dtypes (zeros for a leaf the loss does not reach), every returned
    tensor detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _grad_microbatched(params, batch: Dict[str, torch.Tensor],
                       cfg: ModelConfig, n_micro: int):
    """The batch in ``n_micro`` equal microbatches along its leading dim,
    one forward and backward each; float32 gradient sums, averaged.
    Returns (mean loss, grads (float32), the last microbatch's
    metrics)."""
    rows = {k: v.shape[0] for k, v in batch.items()}
    if any(b % n_micro for b in rows.values()):
        raise ValueError(f"batch rows {rows} do not divide into {n_micro} "
                         "microbatches")
    g_sum = loss_sum = metrics = None
    for i in range(n_micro):
        mb = {k: v[i * (v.shape[0] // n_micro):
                   (i + 1) * (v.shape[0] // n_micro)]
              for k, v in batch.items()}
        loss, metrics, g = value_and_grad(params, mb, cfg)
        if g_sum is None:
            g_sum = tree_map(lambda x: x.to(torch.float32, copy=True), g)
            loss_sum = loss.float()
        else:
            tree_map(lambda a, b: a.add_(b), g_sum, g)
            loss_sum = loss_sum + loss
    return (loss_sum / n_micro, tree_map(lambda x: x / n_micro, g_sum),
            metrics)


def compress_bf16(tree):
    """Cast-to-bf16 gradient compression, the reference's cross-pod
    reduce at half width.  The step does not call it: it waits for the
    data-parallel reduce it would compress (ROADMAP item 19)."""
    return tree_map(lambda g: g.to(torch.bfloat16), tree)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()
                    ) -> Callable:
    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params, opt_state = drop_cast(state["params"]), state["opt"]
        if tcfg.grad_accum > 1:
            loss, grads, metrics = _grad_microbatched(
                params, batch, cfg, tcfg.grad_accum)
        else:
            loss, metrics, grads = value_and_grad(params, batch, cfg)
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, tcfg.opt)
        out_metrics = {"loss": loss, **metrics, **opt_metrics}
        return {"params": new_params, "opt": new_opt}, out_metrics

    return train_step
