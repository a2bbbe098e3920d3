"""Carry numpy trees (weights, page pools) into the port and back.

A tree from the JAX package — ``jax.tree.map(np.asarray, params)`` —
becomes torch tensors with the same nesting (dicts, the per-segment list,
stacked ``(reps, ...)`` leaves) and the same dtypes, so the port's
functions can be fed the reference's exact weights.  bfloat16 crosses as
its raw 16-bit pattern (numpy has no native bfloat16 that torch reads).
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .models.params import tree_map


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy bfloat16; present wherever JAX is
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree: Any, *, device: Union[str, torch.device]) -> Any:
    """numpy (or array-like) tree -> torch tree on ``device`` (required:
    the port picks no device for its caller)."""
    dev = torch.device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def to_numpy(tree: Any) -> Any:
    """torch tree -> numpy tree (host copies)."""
    return tree_map(_to_numpy, tree)
