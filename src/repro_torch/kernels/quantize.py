"""KV-cache quantization: the port of the JAX package's
``kernels/quantize.py``, op for op, so codes and scales are bit-equal to
the reference's on the same inputs.

Scheme (absmax / symmetric):

* GQA pools quantize per (page, line, kv_head) — absmax over head_dim;
  MLA latent pools per (page, line) — absmax over the latent / rope line.
* ``scale = max(absmax / qmax, 1e-12)`` in float32 (qmax 127 for int8,
  448 for fp8_e4m3); the floor guards an all-zero line.
* int8: ``round(x / scale)`` (half to even, as ``jnp.round``) clipped to
  [-127, 127].
* fp8_e4m3: ``x / scale`` clipped to [-448, 448], then cast to
  ``torch.float8_e4m3fn`` — the cast's rounding is the quantization.  The
  clip comes first: torch saturates an out-of-range cast where JAX gives
  NaN.
* dequantize: ``q.float() * scale`` — the op sequence of the paged
  kernels' scale branches and of their plain versions.
"""

from __future__ import annotations

import torch

KV_DTYPES = ("bf16", "int8", "fp8_e4m3")

_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}
# storage dtypes as config dtype strings (models/params.py::torch_dtype)
_STORE = {"int8": "int8", "fp8_e4m3": "float8_e4m3fn"}

# guard a division by an all-zero line (fresh pool pages are zeros)
_SCALE_FLOOR = 1e-12


def validate_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
    return kv_dtype


def is_quantized(kv_dtype: str) -> bool:
    return kv_dtype != "bf16"


def store_dtype(kv_dtype: str, value_dtype: str) -> str:
    """The dtype pages are stored in, as a config dtype string: the model
    dtype for "bf16", else ``"int8"`` / ``"float8_e4m3fn"``."""
    validate_kv_dtype(kv_dtype)
    return _STORE.get(kv_dtype, value_dtype)


def store_itemsize(kv_dtype: str, value_dtype: str) -> int:
    """Bytes per stored KV element."""
    return getattr(torch, store_dtype(kv_dtype, value_dtype)).itemsize


def qmax(kv_dtype: str) -> float:
    return _QMAX[kv_dtype]


def quantize(x: torch.Tensor, kv_dtype: str, dim: int = -1):
    """Quantize ``x`` over ``dim`` (the per-line value axis).  Returns
    ``(q, scale)``: ``q`` in the storage dtype, ``scale`` float32 with
    ``dim`` reduced away; ``dequantize(q, scale)`` inverts it."""
    m = _QMAX[kv_dtype]
    xf = x.float()
    absmax = xf.abs().amax(dim=dim)
    scale = torch.clamp(absmax / m, min=_SCALE_FLOOR)
    y = xf / scale.unsqueeze(dim)
    if kv_dtype == "int8":
        q = torch.clamp(torch.round(y), -m, m).to(torch.int8)
    else:
        q = torch.clamp(y, -m, m).to(torch.float8_e4m3fn)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q.float() * scale`` with scale broadcast over trailing axes."""
    extra = q.dim() - scale.dim()
    return q.float() * scale.reshape(scale.shape + (1,) * extra)
