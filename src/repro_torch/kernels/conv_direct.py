"""Direct convolution (NHWC, HWIO, stride 1, SAME): the CUDA kernel's
wrapper and its plain PyTorch version.

The paper's direct-convolution study: oneDNN blocks NCHW into NCHW16C so
each vector load comes from one cache line.  In NHWC the channels are
already the contiguous dimension, so ``csrc/conv_direct.cu`` (the port of
the Pallas ``conv2d_direct``) runs the convolution as one implicit GEMM
over (N H W) x Cout with K = KH KW Cin, one pixel's channels in one
copy (bf16 on the tensor cores, float32 on the CUDA cores; :func:`plan`
says which producers fill the stages).  Padding is ``KH // 2`` rows
before and ``KH - 1 - KH // 2`` after (columns likewise), the Pallas
wrapper's split: for odd kernels it is XLA's SAME; for even ones it puts
the extra row before, where ``ref.conv2d`` puts it after.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .inner_product import DTYPE_CODES, describe_plan


def pad_split(k: int):
    """(before, after) zero padding of a window of size k."""
    return k // 2, k - 1 - k // 2


def conv2d_direct_reference(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version, the Pallas kernel's loop: pad, then for each window
    offset (dh, dw) add the shifted (N H W, Cin) @ (Cin, Cout) product in
    float32; cast to x.dtype at the end."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = pad_split(kh), pad_split(kw)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    wf = w.float()
    acc = torch.zeros((n * h * wd, cout), dtype=torch.float32,
                      device=x.device)
    for dh in range(kh):
        for dw in range(kw):
            tile = xp[:, dh:dh + h, dw:dw + wd, :].reshape(n * h * wd, cin)
            acc += tile @ wf[dh, dw]
    return acc.reshape(n, h, wd, cout).to(x.dtype)


def conv2d_direct(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA direct-convolution kernel on the current stream (no
    sync).  x (N, H, W, Cin), w (KH, KW, Cin, Cout), contiguous CUDA
    tensors of one dtype (float32 or bf16); returns (N, H, W, Cout) in
    that dtype.  ``launches`` counts the kernel launches this wrapper
    made."""
    if not x.is_cuda:
        raise ValueError(
            "conv2d_direct launches a CUDA kernel and takes CUDA tensors "
            f"only (x is on {x.device}); kernels.ops dispatches CPU tensors "
            "to conv2d_direct_reference")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    for name, t in (("x", x), ("w", w)):
        if (t.dim() != 4 or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want a contiguous 4-D {x.dtype} "
                             f"tensor on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    n, h, wd, cin = x.shape
    kh, kw, cin2, cout = w.shape
    if cin2 != cin or min(n, h, wd, cin, kh, kw, cout) < 1:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "match (NHWC, HWIO)")
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = build.library("conv_direct", C_SIGNATURES)
    err = lib.conv2d_direct_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, cin, cout, kh,
        kw, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct kernel launch failed: CUDA error "
                           f"{err}")
    conv2d_direct.launches += 1
    return out


conv2d_direct.launches = 0


def plan(x: torch.Tensor, w: torch.Tensor) -> str:
    """The path :func:`conv2d_direct` takes for these CUDA tensors (the C
    launch function's own choice; nothing is launched), in
    :func:`describe_plan`'s words."""
    lib = build.library("conv_direct", C_SIGNATURES)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    return describe_plan(lib.conv2d_direct_plan(
        x.data_ptr(), w.data_ptr(), n, h, wd, cin, cout, kh, kw,
        DTYPE_CODES[x.dtype]))


# the C interface of csrc/conv_direct.cu, bound by kernels/build.py
C_SIGNATURES = {
    "conv2d_direct_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        ctypes.c_int),
    "conv2d_direct_plan": (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8, ctypes.c_int),
}
