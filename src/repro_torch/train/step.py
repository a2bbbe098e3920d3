"""The train step: loss -> grads -> clip -> AdamW, with optional
gradient-accumulation microbatching, data parallelism and bf16 gradient
compression: the JAX package's ``train/step.py`` in PyTorch.

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

Data parallelism (``make_train_step(..., mesh=)``, a mesh whose batch
axes have process groups: ``parallel.mesh.dp_axes``) computes what the
reference's GSPMD step computes on the global batch, rank r holding
shard r of each microbatch (``SyntheticLMData(shard=, shards=)``): the
loss, nll and aux are the global batch's on every rank (models/model.py,
models/moe.py), the local gradients are reduced to their mean over the
ranks, and the update is ZeRO-1's (``optimizer.adamw_update_dp``,
moments sharded by ``zero1_spec``).  The reduce runs in the gradients'
dtype, as GSPMD's all-reduce does: each leaf's own with ``grad_accum``
1 (bf16 for a bf16 parameter), float32 when accumulated (the float32
microbatch sum), bf16 for every leaf under ``compress_pod_grads``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import drop_cast, loss_fn, model_param_defs
from ..models.common import ModelConfig
from ..models.params import tree_leaves, tree_map, tree_unflatten
from ..parallel.mesh import Mesh, dp_axes, use_mesh
from .optimizer import (OptConfig, adamw_update, adamw_update_dp,
                        moment_shards)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    grad_accum: int = 1              # microbatch steps per update
    compress_pod_grads: bool = False  # bf16 cross-rank reduce (compress_bf16)


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
    reduce at half width: under ``compress_pod_grads`` the step casts the
    gradients before the cross-rank reduce, which then runs in bf16, and
    they stay bf16 up to the update, which upcasts per tensor (on one
    device the cast alone, as the reference's)."""
    return tree_map(lambda g: g.to(torch.bfloat16), tree)


def dp_wire_bytes(cfg: ModelConfig, sizes: Dict[str, int],
                  tcfg: TrainConfig = TrainConfig(),
                  form: str = "all_reduce") -> Dict[str, float]:
    """The per-device wire bytes of one data-parallel step's collectives
    on a mesh of axis ``sizes``, by axis, counted from the parameter
    defs under the ring model (``op_collectives.CollectiveOp``): per
    leaf, its gradient in the reduce's dtype (the module docstring) over
    ``data``, reduce-scattered to the ZeRO-1 block (``form``
    "reduce_scatter", NCCL's: payload x (n-1)/n) or all-reduced (gloo's
    "all_reduce" form, and every replicated moment: 2 x payload x
    (n-1)/n), plus the parameter's all-gather; over ``pod``, the
    all-reduce of each leaf's reduced block; the clip's vector of
    squared norms (float32, one a leaf) over ``data``; and the loss's
    two float32 token sums, all-reduced forward and backward in every
    microbatch over each axis.  A dense model's whole step; a MoE layer
    adds its dispatch's gathers.  Returns {"data", "pod", "pod_grads"
    (the pod bytes of the gradients alone)}."""
    from ..models.params import torch_dtype
    from .optimizer import zero1_spec
    n, p = sizes.get("data", 1), sizes.get("pod", 1)
    rn, rp = (n - 1) / n, (p - 1) / p
    defs = tree_leaves(model_param_defs(cfg))
    data = pod_grads = 0.0
    for d in defs:
        numel = 1
        for x in d.shape:
            numel *= x
        rdt = (torch.bfloat16 if tcfg.compress_pod_grads else
               torch.float32 if tcfg.grad_accum > 1 else torch_dtype(d.dtype))
        g = numel * rdt.itemsize
        sharded = "data" in zero1_spec(d, sizes)
        if sharded:
            data += (2 if form == "all_reduce" else 1) * g * rn
            data += numel * torch_dtype(d.dtype).itemsize * rn
            pod_grads += 2 * (g / n) * rp
        else:
            data += 2 * g * rn
            pod_grads += 2 * g * rp
    data += 2 * 4 * len(defs) * rn
    loss = 2 * 2 * 8 * tcfg.grad_accum
    return {"data": data + loss * rn, "pod": pod_grads + loss * rp,
            "pod_grads": pod_grads}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig(),
                    mesh: Optional[Mesh] = None) -> Callable:
    """``(state, batch) -> (state, metrics)``.  With ``mesh`` (every rank
    of it calls the step together) the batch is this rank's rows, the
    state's moments its ZeRO-1 blocks (``loop.make_initial_state(...,
    mesh=)``), and the step is the data-parallel one of the module
    docstring; the mesh is made active process-wide while the step runs,
    since its backward runs on the autograd engine's threads."""
    axes = dp_axes(mesh)
    shards = moment_shards(model_param_defs(cfg), mesh) if axes else None

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params, opt_state = drop_cast(state["params"]), state["opt"]
        with (use_mesh(mesh, process_wide=True) if axes
              else contextlib.nullcontext()):
            if tcfg.grad_accum > 1:
                loss, grads, metrics = _grad_microbatched(
                    params, batch, cfg, tcfg.grad_accum)
            else:
                loss, metrics, grads = value_and_grad(params, batch, cfg)
            if tcfg.compress_pod_grads:
                grads = compress_bf16(grads)
            if axes:
                new_params, new_opt, opt_metrics = adamw_update_dp(
                    params, grads, opt_state, tcfg.opt, shards, mesh)
            else:
                new_params, new_opt, opt_metrics = adamw_update(
                    params, grads, opt_state, tcfg.opt)
        out_metrics = {"loss": loss, **metrics, **opt_metrics}
        return {"params": new_params, "opt": new_opt}, out_metrics

    return train_step
