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

from ..models.params import ParamDef, tree_count, tree_nbytes
from ..models.params import tree_map
from .mesh import mesh_axis_sizes

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
# vocab-sharded and the logits edge all-gathers.
DECODE_TP_RULES = DEFAULT.override(
    kv_seq=((),), seq_sp=((),), seq_fb=((),),
    batch=((),), expert_cap=((),), experts=((),),
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
    "DECODE_TP_RULES", "DEFAULT", "DEFAULT_RULES", "DIM_PRIORITY",
    "ParamDef", "ShardingRules", "local_shape", "resolve_spec",
    "shard_leaf", "tree_count", "tree_nbytes", "tree_specs",
]
