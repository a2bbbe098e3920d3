"""Inner product (fully connected): the CUDA kernel's wrapper and its
plain PyTorch version.

``out (M, N) = epilogue(x (M, K) @ w (K, N))`` with a float32 sum; the
epilogue (``"none"``, ``"relu"``, ``"gelu"``: tanh-GELU) runs on the
float32 sum and the result is rounded once to ``x.dtype`` — the paper's
fused "warm cache" case, where the activation never goes back to device
memory.  :func:`inner_product` launches ``csrc/inner_product.cu`` (the
port of the Pallas ``inner_product``); :func:`inner_product_reference` is
the same function in plain PyTorch.  Unlike the Pallas kernel, whose
block sizes must divide the shape, both take any M, N, K >= 1.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from . import ref as _ref

EPILOGUES = {"none": 0, "relu": 1, "gelu": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def apply_epilogue(y: torch.Tensor, fuse: str) -> torch.Tensor:
    """The epilogue on a float32 sum (no cast)."""
    if fuse == "gelu":
        return _ref.gelu(y)
    if fuse == "relu":
        return torch.clamp_min(y, 0.0)
    if fuse != "none":
        raise ValueError(f"fuse must be one of {list(EPILOGUES)}, not "
                         f"{fuse!r}")
    return y


def inner_product_reference(x: torch.Tensor, w: torch.Tensor, *,
                            fuse: str = "none") -> torch.Tensor:
    """Plain version: float32 product, epilogue, one cast to x.dtype."""
    return apply_epilogue(x.float() @ w.float(), fuse).to(x.dtype)


def check_2d(name: str, t: torch.Tensor, dtype: torch.dtype,
             dev: torch.device) -> None:
    """Raise unless ``t`` is a contiguous 2-D tensor of ``dtype`` on
    ``dev``."""
    if t.dim() != 2 or t.dtype != dtype or t.device != dev:
        raise ValueError(f"{name}: want a 2-D {dtype} tensor on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def inner_product(x: torch.Tensor, w: torch.Tensor, *,
                  fuse: str = "none") -> torch.Tensor:
    """Launch the CUDA inner-product kernel on the current stream (no
    sync).  Takes contiguous CUDA tensors only, float32 or bf16, x (M, K)
    and w (K, N) of one dtype; returns (M, N) in that dtype.  ``launches``
    counts the kernel launches this wrapper made."""
    if not x.is_cuda:
        raise ValueError(
            "inner_product launches a CUDA kernel and takes CUDA tensors "
            f"only (x is on {x.device}); kernels.ops dispatches CPU tensors "
            "to inner_product_reference")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    if fuse not in EPILOGUES:
        raise ValueError(f"fuse must be one of {list(EPILOGUES)}, not "
                         f"{fuse!r}")
    check_2d("x", x, x.dtype, x.device)
    check_2d("w", w, x.dtype, x.device)
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2 or min(m, k, n) < 1:
        raise ValueError(f"cannot multiply {tuple(x.shape)} by "
                         f"{tuple(w.shape)}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.library("inner_product", C_SIGNATURES)
    err = lib.inner_product_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
        EPILOGUES[fuse], DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"inner_product kernel launch failed: CUDA error "
                           f"{err}")
    inner_product.launches += 1
    return out


inner_product.launches = 0

# the C interface of csrc/inner_product.cu, bound by kernels/build.py
C_SIGNATURES = {
    "inner_product_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        ctypes.c_int),
}
