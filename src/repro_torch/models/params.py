"""Parameter trees: one definition per leaf (shape, dtype, initializer),
instantiated from an explicit ``torch.Generator``.

Counterpart of ``ParamDef`` / ``stack_defs`` / ``tree_instantiate`` in the
JAX package's ``parallel/sharding.py``.  Each leaf names its dims'
logical axes (``logical``: "heads", "d_ff", ...), which
``parallel/sharding.py`` resolves against a mesh; ``stack_defs``
prepends "layers".  The init rules are the same; the numbers are not,
since torch's generator is not JAX's — tests carry JAX weights across
with :mod:`repro_torch.bridge` instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch


# elements drawn per generator call (a multiple of 16: the CPU generator
# then yields the same stream as one whole-leaf draw)
DRAW_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: str = "float32"
    init: str = "lecun"          # lecun | zeros | ones | normal | embed
    fan_in_axes: Tuple[int, ...] = (-1,)  # axes whose product is fan-in
    scale: float = 1.0
    # logical axis name per dim (parallel/sharding.py DEFAULT_RULES keys)
    logical: Tuple[Optional[str], ...] = ()

    def __post_init__(self):
        if len(self.logical) != len(self.shape):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def instantiate(self, generator: Optional[torch.Generator],
                    device: torch.device) -> torch.Tensor:
        dt = self.torch_dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        if generator is None:
            raise ValueError(f"init {self.init!r} needs a generator")
        fan_in = 1
        for ax in self.fan_in_axes:
            fan_in *= self.shape[ax]
        if self.init == "embed":
            std = self.scale
        elif self.init == "normal":
            std = self.scale * 0.02
        else:  # lecun
            std = self.scale / math.sqrt(max(fan_in, 1))
        n = math.prod(self.shape)
        if n <= DRAW_CHUNK:
            x = torch.randn(self.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            return (x * std).to(device=device, dtype=dt)
        # a large leaf is drawn DRAW_CHUNK elements at a time into its
        # final dtype, so the float32 transient stays one chunk (a whole
        # (reps, 160, 5120, 1536) expert leaf would be 15 GB of float32)
        out = torch.empty(self.shape, dtype=dt, device=device).view(-1)
        for i in range(0, n, DRAW_CHUNK):
            x = torch.randn(min(DRAW_CHUNK, n - i), generator=generator,
                            device=generator.device, dtype=torch.float32)
            out[i:i + x.numel()] = (x * std).to(device=device, dtype=dt)
        return out.view(self.shape)


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config dtypes are strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map over the leaves of nested dicts / lists (dict keys sorted, the
    order JAX flattens them in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(template: Any, leaves: list) -> Any:
    """A tree of ``template``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_paths(tree: Any, prefix: str = "") -> list:
    """(path, leaf) pairs in :func:`tree_leaves` order, a path the dict
    keys and list indices joined by "/" (``params/segments/0/b0/mixer/wq``:
    the JAX package's checkpoint keys)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in tree_paths(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def stack_defs(defs: Any, n: int) -> Any:
    """Prepend a stacked ``(reps, ...)`` layer axis to every ParamDef."""
    def f(d: ParamDef) -> ParamDef:
        return dataclasses.replace(
            d, shape=(n,) + d.shape, logical=("layers",) + d.logical,
            fan_in_axes=tuple(a if a < 0 else a + 1 for a in d.fan_in_axes))
    return tree_map(f, defs)


def instantiate(defs: Any, generator: Optional[torch.Generator],
                device: torch.device) -> Any:
    """Tensors for a tree of ParamDefs, drawn in leaf order from one
    generator (random leaves only; zeros/ones draw nothing)."""
    return tree_map(lambda d: d.instantiate(generator, device), defs)


def tree_count(defs: Any) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def tree_nbytes(defs: Any) -> int:
    return sum(math.prod(d.shape) * torch_dtype(d.dtype).itemsize
               for d in tree_leaves(defs))
