"""Inner product (fully connected): the CUDA kernel's wrapper and its
plain PyTorch version.

``out (M, N) = epilogue(x (M, K) @ w (K, N))`` with a float32 sum; the
epilogue (``"none"``, ``"relu"``, ``"gelu"``: tanh-GELU) runs on the
float32 sum and the result is rounded once to ``x.dtype`` — the paper's
fused "warm cache" case, where the activation never goes back to device
memory.  :func:`inner_product` launches ``csrc/inner_product.cu`` (the
port of the Pallas ``inner_product``): bf16 on the tensor cores
(``csrc/gemm_wgmma.cuh``), float32 on the CUDA cores
(``csrc/gemm_core.cuh``); :func:`inner_product_reference` is the same
function in plain PyTorch.  Unlike the Pallas kernel, whose block sizes
must divide the shape, both take any M, N, K >= 1.  :func:`plan` says
which path and which stage producers a launch takes.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from . import ref as _ref

EPILOGUES = {"none": 0, "relu": 1, "gelu": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the stage producers of csrc/gemm_wgmma.cuh (wg::Producer) and of the
# float32 core csrc/gemm_core.cuh (gemm::Producer: 16-byte cp.async copies,
# or one 4-byte copy per element)
PRODUCERS = ("tma", "cp.async", "element-wise")
F32_PRODUCERS = ("cp.async", "element-wise")


def describe_plan(code: int) -> str:
    """A plan code of the C ``*_plan`` functions in words: the float32
    CUDA-core path (negative: ``gemm::plan_code`` = -2 - (A | B << 1), the
    producers of the A and B stages; -1 names the path alone), or the
    wgmma tile and the producers of the A and B stages (``wg::plan_code``:
    A in bits 0-1, B in bits 2-3, bit 4 for 256 columns)."""
    if code == -1:
        return "cuda-cores f32"
    if code < 0:
        c = -2 - code
        return (f"cuda-cores f32, A {F32_PRODUCERS[c & 1]}, B "
                f"{F32_PRODUCERS[c >> 1 & 1]}")
    return (f"wgmma 128x{256 if code & 16 else 128}, A "
            f"{PRODUCERS[code & 3]}, B {PRODUCERS[code >> 2 & 3]}")


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


def plan(x: torch.Tensor, w: torch.Tensor) -> str:
    """The path :func:`inner_product` takes for these CUDA tensors (the C
    launch function's own choice, from shape and alignment; nothing is
    launched), as :func:`describe_plan` words."""
    lib = build.library("inner_product", C_SIGNATURES)
    (m, k), n = x.shape, w.shape[1]
    return describe_plan(lib.inner_product_plan(
        x.data_ptr(), w.data_ptr(), m, n, k, DTYPE_CODES[x.dtype]))


# the C interface of csrc/inner_product.cu, bound by kernels/build.py
C_SIGNATURES = {
    "inner_product_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        ctypes.c_int),
    "inner_product_plan": (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4, ctypes.c_int),
}
