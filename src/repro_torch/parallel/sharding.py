"""Logical-axis sharding rules with divisibility legalization: the JAX
package's ``parallel/sharding.py`` for explicit SPMD.

Model code never names a mesh axis for a parameter.  Every dim of a
``models.params.ParamDef`` carries a *logical* name ("heads", "d_ff",
...); rules map logical names to candidate mesh-axis tuples, and
:func:`resolve_spec` legalizes them against the mesh's axis sizes so that
a mesh axis is never used twice in one tensor, an axis is used only where
it divides the dim, non-dividing prefixes degrade (("pod", "data") ->
("pod",) -> ()), and freed axes go to lower-priority dims.  The result is
the port's ``PartitionSpec``: a tuple with one entry per leading dim, a
mesh-axis name, a tuple of names, or None, trailing Nones dropped, as
``jax.sharding.PartitionSpec`` holds them.

Explicit SPMD keeps each rank's slice as a tensor of its own
(:func:`shard_leaf`).  The reference's ``constrain`` /
``sharding_context`` are GSPMD hints on intermediate activations inside a
jitted program; with one process per rank there is no partitioner to
hint, so they have no counterpart: the collective edges of
parallel/collectives.py are written where activations cross ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.common import (HEAD_PARALLEL, LocalConfig, LocalLayout,
                             ModelConfig)
from ..models.params import ParamDef, tree_count, tree_nbytes
from ..models.params import tree_map
from .mesh import MODEL_AXIS, mesh_axis_sizes

Candidates = Tuple[Tuple[str, ...], ...]
Spec = Tuple[object, ...]


DEFAULT_RULES: Dict[str, Candidates] = {
    # data-parallel dims
    "batch": (("pod", "data"),),
    "expert_cap": (("data",),),
    # tensor-parallel dims
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "d_ff": (("model",),),
    "vocab": (("model",),),
    "experts": (("model",),),
    "conv_out": (("model",),),
    "heads_q": (("model",),),
    "attn_inner": (("model",),),
    # sequence dims
    "seq": ((),),
    "seq_fb": (("model",),),
    "seq_sp": (("data",), ("model",)),
    "kv_seq": (("model",), ("data",)),
    # replicated-by-default dims
    "d_model": ((),),
    "head_dim": ((),),
    "state": ((),),
    "layers": ((),),
    "none": ((),),
}

# higher = first pick of mesh axes within a tensor
DIM_PRIORITY: Dict[str, int] = {
    "experts": 100,
    "heads": 95,
    "kv_heads": 95,
    "d_ff": 95,
    "vocab": 95,
    "conv_out": 95,
    "heads_q": 90,
    "batch": 85,
    "expert_cap": 75,
    "seq_sp": 65,
    "kv_seq": 60,
    "seq_fb": 55,
}


def _priority(name: str) -> int:
    return DIM_PRIORITY.get(name, 0)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, Candidates]

    def candidates(self, logical: str) -> Candidates:
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.rules[logical]

    def override(self, **kw: Candidates) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(kw)
        return ShardingRules(merged)


DEFAULT = ShardingRules(DEFAULT_RULES)

# Tensor-parallel serve steps (serve/shard.py): heads / kv_heads / d_ff /
# vocab split over ``model``; the page dims (a page is the unit of the
# block-table indirection), the slot batch, the experts and the sequence
# fallbacks stay replicated.  The tied embedding table is replicated by
# serve/shard.py (the token lookup needs every row); an untied head stays
# vocab-sharded and the logits edge all-gathers.  Training takes DEFAULT
# (``models.param_shardings``): the table and the experts on ``model``
# too, the lookup a vocab-sharded one (models/layers.py).
DECODE_TP_RULES = DEFAULT.override(
    kv_seq=((),), seq_sp=((),), seq_fb=((),),
    batch=((),), expert_cap=((),), experts=((),),
)


# --------------------------------------------------------------------------
# The local config a tensor-parallel rank runs (serving and training)
# --------------------------------------------------------------------------

_KV_MIXERS = ("attn", "attn+cross", "cross_attn")


def tp_width_error(cfg: ModelConfig, tp: int, *, train: bool = False
                   ) -> Optional[str]:
    """Why the widths of ``cfg`` cannot be split ``tp`` ways (None when
    they can).  Serving (the default): the query / o heads, the GQA KV
    heads (the KV pools shard over them) and the dense FFN's inner dim
    must divide.  Training and prefill (``train``) take the reference's
    fallbacks instead: query heads that do not divide stay whole and
    attention runs context parallel (``seq_fb``); KV heads that do not
    divide are replicated and each rank slices the one its query heads
    read, which needs ``tp`` to be a multiple of them; a dense ``d_ff``
    that does not divide stays whole."""
    if tp <= 1:
        return None
    if cfg.n_heads % tp:
        if train:
            return None
        return f"{cfg.name}: n_heads {cfg.n_heads} not divisible by tp={tp}"
    kv_mixers = {b.mixer for b in cfg.block_pattern} & set(
        _KV_MIXERS if train else ("attn",))
    if kv_mixers and cfg.n_kv_heads % tp and (not train
                                              or tp % cfg.n_kv_heads):
        return (f"{cfg.name}: n_kv_heads {cfg.n_kv_heads} not divisible "
                f"by tp={tp} (KV pools shard over kv_heads)" if not train
                else f"{cfg.name}: n_kv_heads {cfg.n_kv_heads} neither "
                f"divides nor is divided by tp={tp}")
    if (not train and any(b.ffn == "dense" for b in cfg.block_pattern)
            and cfg.d_ff % tp):
        return f"{cfg.name}: d_ff {cfg.d_ff} not divisible by tp={tp}"
    return None


def tp_local_config(cfg: ModelConfig, tp: int, overlap: str = "none",
                    *, train: bool = False, decode: bool = False
                    ) -> ModelConfig:
    """The config one rank's steps run at tensor-parallel width ``tp``
    (the gates are the caller's: :func:`tp_width_error` and its own):
    local head and FFN counts, an explicit head_dim (it must not
    re-derive from the local head count), ``tp_axis`` naming the axis
    the collective edges reduce over, and ``tp_overlap`` their schedule
    ("none" | "ring").  KV heads that do not divide stay global.  In the
    training-and-prefill mode (``train``) the rank's layouts follow the
    specs the rules resolve: query heads that do not divide stay whole
    (with the KV heads) and attention runs over the rank's rows of the
    sequence; KV heads that do not divide become the one KV head a
    rank's query heads read; a dense ``d_ff`` that does not divide stays
    whole: a ``models.common.LocalConfig`` whose ``layout`` says which.
    ``decode`` (a rank of the static decode step over a dense cache, in
    the training mode's layouts) keeps KV heads that do not divide
    global instead of slicing them: the rules then cut the cache's lines
    over the axis (``LocalLayout.kv_seq``).  vocab_size, n_experts and
    moe_d_ff stay global: the logits edge, the embedding and the MoE
    layer tell a sharded leaf by its shape (a vocabulary that does not
    divide is whole)."""
    train = train or decode
    heads, kv = cfg.n_heads, cfg.n_kv_heads
    cp = train and heads % tp != 0
    sliced, lines = False, decode and kv % tp != 0
    if not cp:
        heads //= tp
        if kv % tp == 0:
            kv //= tp
        elif train and not decode:
            kv, sliced = 1, True
    layout = LocalLayout(sliced, cp, train and cfg.d_ff % tp != 0, lines)
    if layout != HEAD_PARALLEL:
        cfg = LocalConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(ModelConfig)},
                          layout=layout)
    return dataclasses.replace(
        cfg,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=cfg.hd,
        d_ff=cfg.d_ff // tp if cfg.d_ff % tp == 0 else cfg.d_ff,
        tp_axis=MODEL_AXIS,
        tp_overlap=overlap,
    )


def resolve_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                 mesh_sizes: Dict[str, int],
                 rules: ShardingRules = DEFAULT) -> Spec:
    """Resolve logical dim names to a legal spec for these axis sizes."""
    if len(logical) != len(shape):
        raise ValueError(f"logical {logical} does not match shape {shape}")
    n = len(shape)
    assignment: List[Tuple[str, ...]] = [() for _ in range(n)]
    used: set = set()
    order = sorted(range(n), key=lambda i: (-_priority(logical[i] or "none"),
                                            i))
    for i in order:
        name = logical[i] or "none"
        dim = shape[i]
        for cand in rules.candidates(name):
            # the longest prefix of cand present, unused and dividing dim
            chosen: List[str] = []
            prod = 1
            for ax in cand:
                sz = mesh_sizes.get(ax)
                if sz is None or sz == 1 or ax in used:
                    continue
                if dim % (prod * sz) != 0:
                    break
                chosen.append(ax)
                prod *= sz
            if chosen:
                assignment[i] = tuple(chosen)
                used.update(chosen)
                break
    entries = [a[0] if len(a) == 1 else (a or None) for a in assignment]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def tree_specs(defs, mesh, rules: ShardingRules = DEFAULT):
    """The spec of every ParamDef of ``defs`` on ``mesh`` (a Mesh or an
    axis-size dict)."""
    sizes = mesh_axis_sizes(mesh)
    return tree_map(lambda d: resolve_spec(d.logical, d.shape, sizes, rules),
                    defs)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A leaf's shape on one rank under ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for ax in _axes(entry):
            out[i] //= sizes[ax]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Block:
    """A rank's block of a whole leaf: ``pieces`` (dim, axis, index,
    count), cut in order, each keeping the ``index``-th of ``count``
    equal parts of ``dim`` (the rank's coordinate on ``axis``).  A
    parameter's block is its spec's; a ZeRO-1 moment's adds the
    ``data`` piece (train/optimizer.py ``zero1_spec``)."""
    pieces: Tuple[Tuple[int, str, int, int], ...]

    @property
    def dim(self) -> int:
        """The dim of a one-piece block (a ZeRO-1 moment's ``data``
        piece, :meth:`on`)."""
        (dim, _, _, _), = self.pieces
        return dim

    @property
    def count(self) -> int:
        """The number of blocks the whole leaf is cut into."""
        return int(np.prod([p[3] for p in self.pieces]))

    def on(self, axis: str) -> Optional["Block"]:
        """The pieces cut over ``axis`` (None when none is): a ZeRO-1
        moment's ``data`` piece is its block of the rank's parameter
        block, and a ``model`` piece says the parameter is sharded."""
        mine = tuple(p for p in self.pieces if p[1] == axis)
        return Block(mine) if mine else None

    def shape(self, full) -> Tuple[int, ...]:
        out = list(full)
        for dim, _, _, count in self.pieces:
            out[dim] //= count
        return tuple(out)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        for dim, _, index, count in self.pieces:
            k = t.shape[dim] // count
            t = t.narrow(dim, index * k, k)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's block: an all-gather along
        each piece's dim over its axis, last piece first (a collective
        on the active mesh)."""
        from .collectives import all_gather_dim
        for dim, axis, _, _ in reversed(self.pieces):
            t = all_gather_dim(t, dim, axis)
        return t


def leaf_block(spec: Spec, mesh) -> Optional[Block]:
    """This rank's :class:`Block` of a leaf under ``spec`` on ``mesh`` (a
    ``parallel.mesh.Mesh``), None where the leaf is whole on every
    rank."""
    pieces = tuple((dim, ax, mesh.coord(ax), mesh.sizes[ax])
                   for dim, entry in enumerate(spec) for ax in _axes(entry))
    return Block(pieces) if pieces else None


def shard_leaf(tensor: torch.Tensor, spec: Spec, mesh,
               rank: Optional[int] = None) -> torch.Tensor:
    """Rank ``rank``'s block of ``tensor`` under ``spec`` (the mesh's own
    rank by default), a contiguous tensor of its own, so the full one can
    be freed.  A replicated spec returns ``tensor`` itself."""
    sizes = mesh_axis_sizes(mesh)
    names = list(sizes)
    if rank is None:
        rank = mesh.rank
    coords = dict(zip(names, (int(c) for c in np.unravel_index(
        rank, tuple(sizes.values())))))
    out = tensor
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for ax in axes:              # row-major over the dim's axes
            idx = idx * sizes[ax] + coords[ax]
            n *= sizes[ax]
        step = tensor.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    if out is tensor:
        return tensor
    return out.clone(memory_format=torch.contiguous_format)


__all__ = [
    "Block", "DECODE_TP_RULES", "DEFAULT", "DEFAULT_RULES", "DIM_PRIORITY",
    "ParamDef", "ShardingRules", "leaf_block", "local_shape", "resolve_spec",
    "shard_leaf", "tp_local_config", "tp_width_error", "tree_count",
    "tree_nbytes", "tree_specs",
]
