"""Row LayerNorm: the CUDA kernel's wrapper and its plain PyTorch version.

``y = (x - mu) * rsqrt(var + eps) * scale + bias`` over the last axis,
with mu and var taken in float32 by two passes (the mean, then the mean
of the squared deviations) and y rounded once to x's dtype — the Pallas
``layernorm`` (``_ln_kernel``) of the JAX package.  :func:`layernorm`
launches ``csrc/layernorm.cu``; :func:`layernorm_reference` is the same
function in plain PyTorch.  Unlike the Pallas wrapper, whose 256-row
blocks must divide the rows, the kernel takes any number of rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from . import ref as _ref
from .inner_product import DTYPE_CODES

EPS = 1e-5
MAX_D = 57344                  # a float32 row in one block's shared memory


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, *, eps: float = EPS
                        ) -> torch.Tensor:
    """Plain version: two-pass float32 LayerNorm, one cast to x.dtype."""
    return _ref.layernorm(x, scale.float(), bias.float(), eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              eps: float = EPS) -> torch.Tensor:
    """Launch the CUDA LayerNorm kernel over x (..., D) viewed as (R, D)
    on the current stream (no sync).  Takes float32 or bf16 CUDA tensors;
    scale and bias (D,) are read as float32.  ``launches`` counts the
    kernel launches this wrapper made."""
    if not x.is_cuda:
        raise ValueError(
            "layernorm launches a CUDA kernel and takes CUDA tensors only "
            f"(x is on {x.device}); kernels.ops dispatches CPU tensors to "
            "layernorm_reference")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    d = x.shape[-1] if x.dim() else 0
    if x.numel() == 0 or not 1 <= d <= MAX_D:
        raise ValueError(f"x must be non-empty with 1 <= D <= {MAX_D}, got "
                         f"{tuple(x.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (d,) or t.device != x.device:
            raise ValueError(f"{name} must be ({d},) on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    flat = x.contiguous().reshape(-1, d)
    s = scale.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    out = torch.empty_like(flat)
    lib = build.library("layernorm", C_SIGNATURES)
    err = lib.layernorm_launch(
        flat.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
        flat.shape[0], d, float(eps), DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layernorm kernel launch failed: CUDA error "
                           f"{err}")
    layernorm.launches += 1
    return out.reshape(x.shape)


layernorm.launches = 0

# the C interface of csrc/layernorm.cu, bound by kernels/build.py
C_SIGNATURES = {
    "layernorm_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p],
        ctypes.c_int),
}
