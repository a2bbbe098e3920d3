"""KV-cache storage dtypes: the pure-Python half of the JAX package's
``kernels/quantize.py``.  Only unquantized ("bf16", i.e. the model dtype)
pools exist in the port so far; int8 / fp8_e4m3 pools are ROADMAP queue 1
item 5 and raise here."""

from __future__ import annotations

import torch

KV_DTYPES = ("bf16", "int8", "fp8_e4m3")

_QUANTIZED_TODO = ("quantized KV pools (kv_dtype {!r}) are not ported yet: "
                   "ROADMAP queue 1 item 5")


def validate_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
    return kv_dtype


def is_quantized(kv_dtype: str) -> bool:
    return kv_dtype != "bf16"


def store_dtype(kv_dtype: str, value_dtype: str) -> str:
    """The dtype pages are stored in: the model dtype for "bf16"."""
    validate_kv_dtype(kv_dtype)
    if is_quantized(kv_dtype):
        raise NotImplementedError(_QUANTIZED_TODO.format(kv_dtype))
    return value_dtype


def store_itemsize(kv_dtype: str, value_dtype: str) -> int:
    """Bytes per stored KV element (int8 / fp8 would be 1)."""
    validate_kv_dtype(kv_dtype)
    if is_quantized(kv_dtype):
        return 1
    return getattr(torch, value_dtype).itemsize
