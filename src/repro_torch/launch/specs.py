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

from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models import cache_param_defs, model_param_defs
from ..models.common import ModelConfig, ShapeCell
from ..models.params import torch_dtype, tree_map
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


def prefill_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                  mode: Optional[FakeTensorMode] = None):
    """(args, in_specs, None) of ``models.prefill(params, cfg, tokens[,
    source])``, ``cfg`` left out of both."""
    mode = mode or FakeTensorMode()
    defs = model_param_defs(cfg)
    B, S = cell.global_batch, cell.seq_len
    bs = batch_specs(cfg, B, S, mode)
    bsh = batch_shardings(cfg, B, S, mesh)
    args = [_fake_tree(mode, defs), bs["tokens"]]
    in_specs = [shd.tree_specs(defs, mesh), bsh["tokens"]]
    for key in ("enc_embeds", "img_embeds"):
        if key in bs:
            args.append(bs[key])
            in_specs.append(bsh[key])
    return tuple(args), tuple(in_specs), None


def decode_specs(cfg: ModelConfig, cell: ShapeCell, mesh,
                 mode: Optional[FakeTensorMode] = None):
    """(args, in_specs, None) of ``models.decode_step(params, cfg,
    caches, token, pos)``, ``cfg`` left out: one new token a row against
    a seq_len-deep dense cache (pos (B,) int32, the port's position a
    row)."""
    mode = mode or FakeTensorMode()
    defs = model_param_defs(cfg)
    B, S = cell.global_batch, cell.seq_len
    cdefs = cache_param_defs(cfg, B, S)
    sizes = mesh_axis_sizes(mesh)
    args = (_fake_tree(mode, defs), _fake_tree(mode, cdefs),
            _fake(mode, (B, 1), "int32"), _fake(mode, (B,), "int32"))
    in_specs = (shd.tree_specs(defs, mesh), shd.tree_specs(cdefs, mesh),
                shd.resolve_spec(["batch", None], [B, 1], sizes),
                shd.resolve_spec(["batch"], [B], sizes))
    return args, in_specs, None
