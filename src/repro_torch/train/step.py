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

Tensor parallelism (a mesh with a ``model`` group, alone or beside the
batch axes) computes what the reference's GSPMD step computes under
``launch/specs.py::train_specs`` shardings: every rank holds its blocks
of the parameters under the DEFAULT rules (``models.param_shardings``:
heads, kv_heads, d_ff, vocab and experts on ``model``) and runs the
parent step's body on its local config (:func:`train_local_config`),
whose forward crosses ranks only at the differentiable tp edges
(``parallel.collectives.tp_copy`` / ``tp_reduce``, the logits'
``all_gather_cols``): the same loss, nll, aux, gradient norm and
update, up to the order of the row-parallel sums.  The ranks of one
``model`` row take the same batch rows; ZeRO-1 cuts each rank's model
block along ``data`` (optimizer.py), and the clip's norm sums a
model-sharded leaf's squares over ``model``.  Where the query heads do
not divide ``model`` the rank's attention runs context parallel instead
(the reference's ``seq_fb`` layout, a ``models.common.LocalLayout``
``context_parallel``): the heads whole, the rank's rows of the
sequence, the rows gathered after the o-projection.
:func:`tp_wire_bytes` counts a step's ``model``-axis bytes by edge.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import drop_cast, loss_fn, model_param_defs, param_shardings
from ..models.common import ModelConfig
from ..models.params import tree_leaves, tree_map, tree_unflatten
from ..models.transformer import check_supported, remat_mode
from ..parallel import sharding as shd
from ..parallel.mesh import MODEL_AXIS, Mesh, holds_blocks, use_mesh
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
    adds its dispatch's gathers.  Under a ``model`` axis each leaf counts
    its rank's model block.  Returns {"data", "pod", "pod_grads" (the
    pod bytes of the gradients alone)}."""
    from ..models.params import torch_dtype
    from .optimizer import zero1_spec
    n, p = sizes.get("data", 1), sizes.get("pod", 1)
    rn, rp = (n - 1) / n, (p - 1) / p
    all_defs = model_param_defs(cfg)
    defs = tree_leaves(all_defs)
    specs: list = []     # tree_leaves would walk into the spec tuples
    tree_map(lambda d, sp: specs.append(sp), all_defs,
             param_shardings(cfg, sizes))
    data = pod_grads = 0.0
    for d, sp in zip(defs, specs):
        numel = 1
        for x in shd.local_shape(d.shape, sp, sizes):
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


def tp_wire_bytes(cfg: ModelConfig, sizes: Dict[str, int], B: int, S: int,
                  tcfg: TrainConfig = TrainConfig()) -> Dict[str, float]:
    """The per-device ``model``-axis wire bytes of one train step of
    ``cfg`` on a mesh of axis ``sizes`` (global batch ``B`` x ``S``), by
    edge, under the ring model (``op_collectives.CollectiveOp``: an
    all-reduce of p bytes puts 2 p (n-1)/n on the wire, an all-gather's
    result of p bytes p (n-1)/n).  In every microbatch of a rank's
    T = B / batch shards / grad_accum x S tokens (activations in the
    model dtype):

    * ``tp_reduce`` (forward): the vocab-sharded embedding's (T, D); per
      head-sharded attention the o-projection's (two for self + cross
      attention), per split FFN its own (a MoE layer's one, routed plus
      shared);
    * ``seq_gather`` (forward): per context-parallel attention (query
      heads that do not divide ``model``, over a sequence that does) the
      o-projection's (T, D) rows gathered, or under ``tp_attn_inner`` o's
      (T, H x hd) rows, then the flat o-projection's ``tp_reduce``;
    * under remat "full" / "dots" the recompute of a checkpointed body
      (a segment's unit, an encoder layer under "full") runs its forward
      collectives again up to the last compute that saves a tensor for
      the backward: torch stops a recompute there, so a body ending in
      a collective (a split FFN's reduce) runs all but that one again,
      and one ending in a whole FFN all of them;
    * ``tp_copy`` (backward): per head-sharded attention layer the
      (T, D) input, a cross-attention source that carries a gradient
      (whisper's encoder output, not an image embedding), the two
      qk-norm scales (float32), ``wk`` and ``wv`` where the KV heads are
      replicated and sliced; per context-parallel one the input, such a
      source, the qk-norm scales and all four weights (each rank reads
      them for its rows), and under ``tp_attn_inner`` the gathered o;
      per MLA layer ``c_q`` (x without a q latent), ``c_kv`` and
      ``k_rope``; per split FFN its input, a MoE layer's float32 gates
      (T, k) as well; the logits' input;
    * ``tp_gather`` (forward): the logits' (T, V);
    * ``norm``: the clip's float32 vector of squares, one a leaf, once a
      step.

    A vocabulary or a dense ``d_ff`` the axis does not divide stays
    whole (no edges), as does attention over a sequence it does not
    divide (whisper's 1500 encoder frames at 16).  ``model`` is the sum.
    All zeros without a ``model`` axis."""
    from ..models.params import torch_dtype
    from ..parallel.mesh import batch_shards
    n = sizes.get(MODEL_AXIS, 1)
    out = dict.fromkeys(("tp_copy", "tp_reduce", "tp_gather", "seq_gather",
                         "norm"), 0.0)
    if n <= 1:
        return {"model": 0.0, **out}
    ring = (n - 1) / n
    isz = torch_dtype(cfg.dtype).itemsize
    rows = B // batch_shards(sizes) // tcfg.grad_accum
    T = rows * S
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cp = H % n != 0                       # context-parallel attention

    def ar(elems: float, size: int = isz) -> float:
        return 2.0 * elems * size * ring

    def ag(elems: float) -> float:
        return elems * isz * ring

    act = ar(T * D)
    copy = 0.0
    fwd = {"tp_reduce": 0.0, "seq_gather": 0.0}
    if cfg.vocab_size % n == 0:
        fwd["tp_reduce"] += act                        # the embedding
        copy += act                                    # the logits' input
        out["tp_gather"] = T * cfg.vocab_size * isz * ring * tcfg.grad_accum

    SAVE = ("save", 0.0)        # compute that saves tensors for backward

    def attn(cross: bool, q_len: int, src_elems: float):
        """(tp_copy bytes, forward events in order: SAVE, (edge, bytes))
        of one attention over q_len rows a batch row; ``src_elems`` the
        elements of a cross source that carries a gradient."""
        tq = rows * q_len * D
        c = ar(tq) + (ar(src_elems) if cross else 0.0)
        if cfg.qk_norm:
            c += 2 * ar(hd, 4)
        if not cp:
            if KV % n:
                c += 2 * ar(D * KV * hd)
            return c, [SAVE, ("tp_reduce", ar(tq))]
        if q_len % n:
            return 0.0, [SAVE]                         # whole on every rank
        c += ar(2 * D * H * hd + 2 * D * KV * hd)
        if cfg.tp_attn_inner and (H * hd) % n == 0:
            c += ar(rows * q_len * H * hd)
            return c, [SAVE, ("seq_gather", ag(rows * q_len * H * hd)),
                       SAVE, ("tp_reduce", ar(tq))]
        return c, [SAVE, ("seq_gather", ag(tq))]

    enc_src = rows * cfg.n_audio_frames * D if cfg.is_encoder_decoder else 0

    def ffn(kind: str, tokens: int):
        if kind == "none":
            return 0.0, []
        if kind == "dense" and cfg.d_ff % n:
            return 0.0, [SAVE]                         # whole on every rank
        t = ar(tokens * D)
        c = t + (ar(tokens * cfg.moe_top_k, 4) if kind == "moe" else 0.0)
        return c, [SAVE, ("tp_reduce", t)]

    def block(b):
        """(tp_copy bytes, forward events in order) of one block."""
        parts = []
        if b.mixer in ("attn", "attn+cross"):
            parts.append(attn(False, S, 0))
        if b.mixer in ("cross_attn", "attn+cross"):
            parts.append(attn(True, S, enc_src))
        if b.mixer == "mla":
            q = cfg.q_lora_rank or D
            parts.append((ar(T * (q + cfg.kv_lora_rank + cfg.rope_head_dim)),
                          [SAVE, ("tp_reduce", act)]))
        parts.append(ffn(b.ffn, T))
        return (sum(p[0] for p in parts),
                [e for p in parts for e in p[1]])

    def body(each, reps: int, remat: bool):
        """Add ``reps`` runs of a body of blocks ``each`` ((copy, events)
        a block); with ``remat`` its recompute runs the collectives
        before its last saving compute again."""
        nonlocal copy
        events = [e for _, es in each for e in es]
        last = max((i for i, e in enumerate(events) if e is SAVE),
                   default=0)
        again = events[:last] if remat else []
        copy += reps * sum(c for c, _ in each)
        for edge, nbytes in events + again:
            if edge != "save":
                fwd[edge] += reps * nbytes

    mode = remat_mode(cfg)
    for unit, reps in cfg.segments():
        body([block(b) for b in unit], reps, mode != "none")
    if cfg.is_encoder_decoder:
        F = cfg.n_audio_frames
        body([attn(False, F, 0), ffn("dense", rows * F)],
             cfg.n_encoder_layers, mode == "full")
    out["tp_copy"] = copy * tcfg.grad_accum
    out["tp_reduce"] = fwd["tp_reduce"] * tcfg.grad_accum
    out["seq_gather"] = fwd["seq_gather"] * tcfg.grad_accum
    out["norm"] = ar(len(tree_leaves(model_param_defs(cfg))), 4)
    return {"model": sum(out.values()), **out}


def tp_size(mesh: Optional[Mesh]) -> int:
    """The width of ``mesh``'s ``model`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.sizes.get(MODEL_AXIS, 1)


def train_tp_error(cfg: ModelConfig, tp: int) -> Optional[str]:
    """Why a train step of ``cfg`` cannot split its widths ``tp`` ways
    (None when it can): the shared gates in the training mode
    (``parallel.sharding.tp_width_error(..., train=True)``: query heads
    that do not divide run context parallel, KV heads replicated and
    sliced where they do not divide, a dense ``d_ff`` whole), MLA's
    query heads, which must divide (its latent path has no
    context-parallel form), and a MoE layer's: its experts or their
    ``d_ff``, and the shared experts' ``d_ff``, must divide, or its
    output would not be one partial sum.  Recurrent mixers:
    ``check_supported``."""
    if tp <= 1:
        return None
    if cfg.use_mla and cfg.n_heads % tp:
        return (f"{cfg.name}: MLA n_heads {cfg.n_heads} not divisible by "
                f"model={tp} (context-parallel MLA is not ported)")
    if any(b.ffn == "moe" for b in cfg.block_pattern):
        if cfg.n_experts % tp and cfg.moe_d_ff % tp:
            return (f"{cfg.name}: neither n_experts {cfg.n_experts} nor "
                    f"moe_d_ff {cfg.moe_d_ff} divisible by model={tp}")
        if (cfg.moe_d_ff * cfg.n_shared_experts) % tp:
            return (f"{cfg.name}: the shared experts' d_ff "
                    f"{cfg.moe_d_ff * cfg.n_shared_experts} not divisible "
                    f"by model={tp}")
    return shd.tp_width_error(cfg, tp, train=True)


def train_local_config(cfg: ModelConfig, mesh: Optional[Mesh]
                       ) -> ModelConfig:
    """The config a rank's train step runs on ``mesh``: ``cfg`` itself
    without a ``model`` axis, else ``parallel.sharding.tp_local_config``
    in its training mode (serving's where every width divides; KV heads
    sliced where the rules replicate them, context-parallel attention
    where the query heads do not divide), behind
    ``check_supported(cfg, train_tp=)`` and :func:`train_tp_error`."""
    return _local_config(cfg, mesh, decode=False)


def _local_config(cfg: ModelConfig, mesh: Optional[Mesh], *,
                  decode: bool) -> ModelConfig:
    tp = tp_size(mesh)
    if tp <= 1:
        return cfg
    check_supported(cfg, train_tp=tp)
    err = train_tp_error(cfg, tp)
    if err:
        raise NotImplementedError(err)
    return shd.tp_local_config(cfg, tp, cfg.tp_overlap, train=True,
                               decode=decode)


def decode_local_config(cfg: ModelConfig, mesh: Optional[Mesh]
                        ) -> ModelConfig:
    """The config a rank's static decode step (``models.decode_step``
    over its blocks of the dense cache) runs on ``mesh``: ``cfg`` without
    a ``model`` axis, else the training mode's layouts
    (:func:`train_local_config`'s gates) except that KV heads that do not
    divide ``model`` stay global: the rules cut the cache's lines over it
    instead (``parallel.sharding.tp_local_config(..., decode=True)``, a
    ``kv_seq`` layout).  MLA's latent lines are cut whatever the heads."""
    return _local_config(cfg, mesh, decode=True)


def decode_wire_bytes(cfg: ModelConfig, sizes: Dict[str, int], B: int,
                      S: int) -> Dict[str, float]:
    """The per-device ``model``-axis wire bytes of one static decode step
    of ``cfg`` (a global batch of ``B`` rows, one token each, against an
    ``S``-line dense cache) on a mesh of axis ``sizes``, by edge, under
    the ring model of :func:`tp_wire_bytes` (a gather's result of p bytes
    puts p (n-1)/n on the wire).  For a rank's T = B / batch shards rows:

    * ``kv_merge``: per attention over cut lines (self attention where
      the KV heads do not divide ``model``; its cross attention where
      the axis also divides the source's lines; MLA always) the
      all-gather of every head's output with its float32 log-sum-exp:
      (n - 1) T H (w itemsize + 4), w = hd (GQA), ``kv_lora_rank``
      (absorbed MLA) or ``v_head_dim`` (expanded);
    * ``head_gather``: where the query heads are split, each such
      attention's (T, H, hd) queries (MLA: q_rope, and q_lat absorbed or
      q_nope expanded, whose ``wk_b`` and ``wv_b`` are gathered whole
      too);
    * ``tp_reduce``: the vocab-sharded embedding's (T, D); per attention
      with split heads (or under ``tp_attn_inner`` where they are whole
      and H hd divides) the o-projection's (T, D); per split FFN its own
      (a MoE layer's one; a dense ``d_ff`` that does not divide runs
      whole);
    * ``tp_gather``: the logits' (T, V).

    ``model`` is the sum; all zeros without a ``model`` axis.  ``S``
    only decides whether the lines are cut, which decode needs: an S the
    axis does not divide is refused."""
    from ..models.params import torch_dtype
    from ..models.transformer import cross_len
    from ..parallel.mesh import batch_shards
    n = sizes.get(MODEL_AXIS, 1)
    out = dict.fromkeys(("kv_merge", "head_gather", "tp_reduce",
                         "tp_gather"), 0.0)
    if n <= 1:
        return {"model": 0.0, **out}
    if S % n:
        raise NotImplementedError(
            f"a {S}-line dense cache does not divide model={n}")
    ring = (n - 1) / n
    isz = torch_dtype(cfg.dtype).itemsize
    T = B // batch_shards(sizes)
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    split = H % n == 0                    # query heads split over model

    def ar(elems: float) -> float:
        return 2.0 * elems * isz * ring

    def ag(elems: float) -> float:
        return elems * isz * ring

    def merge(width: int) -> float:
        return (n - 1) * T * H * (width * isz + 4)

    def oproj() -> float:
        if split or (cfg.tp_attn_inner and (H * hd) % n == 0):
            return ar(T * D)
        return 0.0

    def attn(cut: bool):
        if KV % n == 0:                   # head parallel: every line
            out["tp_reduce"] += ar(T * D)
            return
        if split:
            out["head_gather"] += ag(T * H * hd)
        if cut:
            out["kv_merge"] += merge(hd)
        out["tp_reduce"] += oproj()

    def mla():
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        dn, dv = cfg.nope_head_dim, cfg.v_head_dim
        if cfg.mla_absorb:
            out["head_gather"] += ag(T * H * (r + dr))
            out["kv_merge"] += merge(r)
        else:
            out["head_gather"] += ag(T * H * (dn + dr) + r * H * (dn + dv))
            out["kv_merge"] += merge(dv)
        out["tp_reduce"] += ar(T * D)

    if cfg.vocab_size % n == 0:
        out["tp_reduce"] += ar(T * D)                  # the embedding
        out["tp_gather"] += ag(T * cfg.vocab_size)     # the logits
    for unit, reps in cfg.segments():
        for _ in range(reps):
            for b in unit:
                if b.mixer in ("attn", "attn+cross"):
                    attn(True)
                if b.mixer in ("cross_attn", "attn+cross"):
                    attn(cross_len(cfg, b) % n == 0)
                if b.mixer == "mla":
                    mla()
                if b.ffn == "moe" or (b.ffn == "dense" and cfg.d_ff % n == 0):
                    out["tp_reduce"] += ar(T * D)
    return {"model": sum(out.values()), **out}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig(),
                    mesh: Optional[Mesh] = None) -> Callable:
    """``(state, batch) -> (state, metrics)``.  With ``mesh`` (every rank
    of it calls the step together) the batch is this rank's rows, the
    state its parameter blocks and their moments' ZeRO-1 blocks
    (``loop.make_initial_state(..., mesh=)``), and the step is the data-
    and tensor-parallel one of the module docstring on
    :func:`train_local_config`; the mesh is made active process-wide
    while the step runs, since its backward, and the recompute of its
    checkpointed layers, run on the autograd engine's threads."""
    step_cfg = train_local_config(cfg, mesh)
    ranks = holds_blocks(mesh)
    shards = moment_shards(model_param_defs(cfg), mesh) if ranks else None

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params, opt_state = drop_cast(state["params"]), state["opt"]
        with (use_mesh(mesh, process_wide=True) if ranks
              else contextlib.nullcontext()):
            if tcfg.grad_accum > 1:
                loss, grads, metrics = _grad_microbatched(
                    params, batch, step_cfg, tcfg.grad_accum)
            else:
                loss, metrics, grads = value_and_grad(params, batch,
                                                      step_cfg)
            if tcfg.compress_pod_grads:
                grads = compress_bf16(grads)
            if ranks:
                new_params, new_opt, opt_metrics = adamw_update_dp(
                    params, grads, opt_state, tcfg.opt, shards, mesh)
            else:
                new_params, new_opt, opt_metrics = adamw_update(
                    params, grads, opt_state, tcfg.opt)
        out_metrics = {"loss": loss, **metrics, **opt_metrics}
        return {"params": new_params, "opt": new_opt}, out_metrics

    return train_step
