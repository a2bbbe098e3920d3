"""Carry numpy trees (weights, page pools) into the port and back.

A tree from the JAX package — ``jax.tree.map(np.asarray, params)`` —
becomes torch tensors with the same nesting (dicts, the per-segment list,
stacked ``(reps, ...)`` leaves) and the same dtypes, so the port's
functions can be fed the reference's exact weights.  bfloat16 crosses as
its raw 16-bit pattern and float8_e4m3fn (quantized KV pools) as its raw
byte (numpy has neither type natively; ``ml_dtypes``, which JAX brings,
gives them to numpy).
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .models.params import tree_map


# dtypes numpy holds only through ml_dtypes: name -> (torch dtype, the
# same-width integer the bits cross as)
_RAW = {"bfloat16": (torch.bfloat16, np.int16),
        "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _RAW:
        dt, raw = _RAW[a.dtype.name]
        t = torch.from_numpy(np.array(a, copy=True).view(raw))
        return t.view(dt).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    for name, (dt, raw) in _RAW.items():
        if t.dtype == dt:
            import ml_dtypes  # numpy bfloat16 / fp8; present wherever JAX is
            return t.view(getattr(torch, np.dtype(raw).name)).numpy().view(
                getattr(ml_dtypes, name))
    return t.numpy()


def to_torch(tree: Any, *, device: Union[str, torch.device]) -> Any:
    """numpy (or array-like) tree -> torch tree on ``device`` (required:
    the port picks no device for its caller)."""
    dev = torch.device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def to_numpy(tree: Any) -> Any:
    """torch tree -> numpy tree (host copies)."""
    return tree_map(_to_numpy, tree)
