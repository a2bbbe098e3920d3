"""Fake-tensor input specs and spec trees for every (arch x shape) cell:
the JAX package's ``launch/specs.py``.

Where the reference hands ``ShapeDtypeStruct`` stand-ins to ``jax.jit``'s
lowering, the port hands fake CPU tensors (``FakeTensorMode``: shapes and
dtypes, no storage) to the op-level walk (``core/analysis.py::
analyze_step``), so a full-width step is characterized without computing
or allocating it.  The tensors of one call share one mode (a walk needs
its arguments' own mode).  Shardings are the port's spec trees
(``parallel/sharding.py``): one spec per leaf of the argument it
partitions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models import abstract_params, cache_param_defs, model_param_defs
from ..models.common import ModelConfig, ShapeCell, model_flops
from ..models.params import ParamDef, torch_dtype, tree_map
from ..models.transformer import cross_len
from ..parallel import sharding as shd
from ..parallel.mesh import batch_shards, holds_blocks, mesh_axis_sizes
from ..train.loop import abstract_state
from ..train.optimizer import opt_state_shardings


def _fake(mode: FakeTensorMode, shape, dtype: str) -> torch.Tensor:
    with mode:
        return torch.empty(tuple(shape), dtype=torch_dtype(dtype))


def _fake_tree(mode: FakeTensorMode, defs):
    return tree_map(lambda d: _fake(mode, d.shape, d.dtype), defs)


def _fake_like(mode: FakeTensorMode, tree):
    """Fake CPU tensors of a tree of meta tensors' shapes and dtypes."""
    def like(t):
        with mode:
            return torch.empty(t.shape, dtype=t.dtype)
    return tree_map(like, tree)


def batch_specs(cfg: ModelConfig, B: int, S: int,
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """A train batch of B rows of S tokens (``train/data.py``'s keys)."""
    mode = mode or FakeTensorMode()
    out = {"tokens": _fake(mode, (B, S), "int32"),
           "labels": _fake(mode, (B, S), "int32")}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = _fake(mode, (B, cfg.n_audio_frames, cfg.d_model),
                                  cfg.dtype)
    if cfg.n_image_tokens:
        out["img_embeds"] = _fake(mode, (B, cfg.n_image_tokens, cfg.d_model),
                                  cfg.dtype)
    return out


def batch_shardings(cfg: ModelConfig, B: int, S: int, mesh
                    ) -> Dict[str, Any]:
    sizes = mesh_axis_sizes(mesh)

    def spec(shape, *logical):
        return shd.resolve_spec(list(logical), list(shape), sizes)

    out = {"tokens": spec((B, S), "batch", "seq"),
           "labels": spec((B, S), "batch", "seq")}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = spec((B, cfg.n_audio_frames, cfg.d_model),
                                 "batch", "seq", "d_model")
    if cfg.n_image_tokens:
        out["img_embeds"] = spec((B, cfg.n_image_tokens, cfg.d_model),
                                 "batch", "seq", "d_model")
    return out


def train_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                mode: Optional[FakeTensorMode] = None
                ) -> Tuple[Tuple[Any, ...], Tuple[Any, ...], Any]:
    """(args, in_specs, out_specs) of ``train_step(state, batch)``: the
    state of ``train/loop.py::abstract_state`` (parameters in their
    dtypes, float32 moments, an int32 step) as fake tensors.  The args
    are one rank's: on a mesh of ranks (``parallel.mesh.holds_blocks``:
    ``(data, model)`` or ``(pod, data, model)``, or a rank's view) the
    batch is its global_batch / batch shards rows (the ranks of one
    ``model`` row take the same ones), the parameters its blocks and the
    moments their ZeRO-1 blocks, what the rank's step really takes; the
    specs stay the global arrays' partitioning."""
    mode = mode or FakeTensorMode()
    defs = model_param_defs(cfg)
    ranks = holds_blocks(mesh)
    state = _fake_like(mode, abstract_state(cfg, mesh if ranks else None))
    state_specs = {"params": shd.tree_specs(defs, mesh),
                   "opt": opt_state_shardings(defs, mesh)}
    B, S = cell.global_batch, cell.seq_len
    rows = B // batch_shards(mesh) if ranks else B
    args = (state, batch_specs(cfg, rows, S, mode))
    in_specs = (state_specs, batch_shardings(cfg, B, S, mesh))
    return args, in_specs, (state_specs, None)


def exact_cache_defs(cfg: ModelConfig, B: int, S: int):
    """The dense cache's defs (``cache_param_defs``) with its lines at
    their own counts (S, the source's frames or image tokens for cross
    attention): the reference's cache shapes, without the static
    engine's rounding to 16 lines."""
    def unrounded(d: ParamDef, lines: int) -> ParamDef:
        if "kv_seq" not in d.logical:     # a recurrent mixer's state
            return d
        i = d.logical.index("kv_seq")
        return dataclasses.replace(d, shape=d.shape[:i] + (lines,)
                                   + d.shape[i + 1:])

    segs = []
    for seg, (unit, _) in zip(cache_param_defs(cfg, B, S), cfg.segments()):
        segs.append({bk: {k: unrounded(d, cross_len(cfg, unit[int(bk[1:])])
                                       if k in ("ck", "cv") else S)
                          for k, d in leaves.items()}
                     for bk, leaves in seg.items()})
    return segs


def prefill_cache_specs(cfg: ModelConfig, B: int, S: int, mesh):
    """The spec of every leaf of ``models.prefill``'s states for a global
    batch of B prompts of S tokens on ``mesh``: the dense cache's at its
    lines' own counts (:func:`exact_cache_defs`).  Where the KV heads do
    not divide ``model`` the rules put ``kv_seq`` on it (a rank holds its
    rows of the lines), else the KV heads; MLA's latent lines always
    take it.  A decode step's cache blocks are the same
    (:func:`decode_specs`)."""
    return shd.tree_specs(exact_cache_defs(cfg, B, S), mesh)


def prefill_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                  mode: Optional[FakeTensorMode] = None):
    """(args, in_specs, out_specs) of ``models.prefill(params, cfg,
    tokens[, source])``, ``cfg`` left out of all three.  On a mesh of
    ranks (``parallel.mesh.holds_blocks``, as :func:`train_specs`) the
    args are one rank's: its global_batch / batch shards rows of the
    prompts (and of the source) and its parameter blocks; the rank runs
    ``prefill(..., cache_blocks=True)`` on its
    ``train.step.train_local_config`` and returns the whole last logits
    and its blocks of the cache, whose specs are ``out_specs[1]``
    (:func:`prefill_cache_specs`)."""
    mode = mode or FakeTensorMode()
    ranks = holds_blocks(mesh)
    B, S = cell.global_batch, cell.seq_len
    rows = B // batch_shards(mesh) if ranks else B
    bs = batch_specs(cfg, rows, S, mode)
    bsh = batch_shardings(cfg, B, S, mesh)
    params = _fake_like(mode, abstract_params(cfg, mesh if ranks else None))
    args = [params, bs["tokens"]]
    in_specs = [shd.tree_specs(model_param_defs(cfg), mesh), bsh["tokens"]]
    for key in ("enc_embeds", "img_embeds"):
        if key in bs:
            args.append(bs[key])
            in_specs.append(bsh[key])
    out_specs = (None, prefill_cache_specs(cfg, B, S, mesh))
    return tuple(args), tuple(in_specs), out_specs


def decode_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                 mode: Optional[FakeTensorMode] = None):
    """(args, in_specs, None) of ``models.decode_step(params, cfg,
    caches, token, pos)``, ``cfg`` left out: one new token a row against
    a seq_len-deep dense cache (pos (B,) int32, the port's position a
    row).  On a mesh of ranks (``parallel.mesh.holds_blocks``, as
    :func:`prefill_specs`) the args are one rank's: its parameter
    blocks, its block of the dense cache (:func:`exact_cache_defs` cut by
    its specs: its rows of the lines where the KV heads do not divide
    ``model``, MLA's latent lines always, else its KV heads), a
    (global_batch / batch shards, 1) token and a (global_batch / batch
    shards,) pos; the rank runs ``decode_step`` on its
    ``train.step.decode_local_config``.  Otherwise the global arrays at
    the static engine's cache shapes."""
    mode = mode or FakeTensorMode()
    defs = model_param_defs(cfg)
    B, S = cell.global_batch, cell.seq_len
    sizes = mesh_axis_sizes(mesh)
    param_specs = shd.tree_specs(defs, mesh)
    if holds_blocks(mesh):
        exact = exact_cache_defs(cfg, B, S)
        cache_specs = shd.tree_specs(exact, mesh)
        rows = B // batch_shards(mesh)
        params = _fake_like(mode, abstract_params(cfg, mesh))
        caches = tree_map(lambda d, sp: _fake(
            mode, shd.local_shape(d.shape, sp, mesh), d.dtype), exact,
            cache_specs)
    else:
        cdefs = cache_param_defs(cfg, B, S)
        cache_specs = shd.tree_specs(cdefs, mesh)
        rows = B
        params, caches = _fake_tree(mode, defs), _fake_tree(mode, cdefs)
    args = (params, caches, _fake(mode, (rows, 1), "int32"),
            _fake(mode, (rows,), "int32"))
    in_specs = (param_specs, cache_specs,
                shd.resolve_spec(["batch", None], [B, 1], sizes),
                shd.resolve_spec(["batch"], [B], sizes))
    return args, in_specs, None


def cell_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS of one cell (``models.common.model_flops``), the
    reference's ``cell_flops``."""
    return model_flops(cfg, cell.seq_len, cell.global_batch, cell.kind)
