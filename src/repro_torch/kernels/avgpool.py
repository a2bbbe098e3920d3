"""Average pooling (window x window, stride = window), blocked vs naive
walk: the CUDA kernels' wrappers and their plain PyTorch versions.

The paper's pooling study (figure 7, section 3.3): average pooling over
NCHW reached 0.35% of peak against 14.8% for a blocked layout with the
channels contiguous, at the same arithmetic intensity.  The JAX package
keeps the contrast with two Pallas kernels, and so does the port:

* :func:`avg_pool_blocked` launches ``csrc/avgpool.cu``'s NHWC kernel
  (the port of ``_pool_nhwc_kernel``): neighbouring threads take
  neighbouring channels;
* :func:`avg_pool_naive` keeps the reference wrapper's steps: crop,
  transpose NHWC -> NCHW, the NCHW kernel (:func:`avg_pool_nchw`, the port
  of ``_pool_nchw_kernel``: threads across W, each window a stride-2
  walk), and the transpose back.

Both sum each window in float32 in the same order and divide by
window^2, so they agree bit for bit; H and W are cropped to whole
windows, as the reference crops them.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from . import build
from . import ref as _ref
from .inner_product import DTYPE_CODES


def avg_pool_reference(x: torch.Tensor, *, window: int = 2
                       ) -> torch.Tensor:
    """Plain version of both walks over NHWC x."""
    return _ref.avg_pool(x, window, window)


def avg_pool_nchw_reference(xc: torch.Tensor, *, window: int = 2
                            ) -> torch.Tensor:
    """Plain version of the NCHW kernel: the same pooling over the
    (N, C, H, W) view."""
    return _ref.avg_pool(xc.permute(0, 2, 3, 1), window,
                         window).permute(0, 3, 1, 2)


def _check(x: torch.Tensor, window: int, fn: str) -> None:
    if not x.is_cuda:
        raise ValueError(
            f"{fn} launches a CUDA kernel and takes CUDA tensors only (x is "
            f"on {x.device}); kernels.ops dispatches CPU tensors to the "
            "plain version")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    if x.dim() != 4 or max(x.shape) >= 2 ** 31:
        raise ValueError(f"x must be a 4-D tensor with dims below 2^31, got "
                         f"{tuple(x.shape)}")
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, not {window}")


def _launch(fn: str, *args) -> None:
    lib = build.library("avgpool", C_SIGNATURES)
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def avg_pool_blocked(x: torch.Tensor, *, window: int = 2) -> torch.Tensor:
    """Launch the blocked (NHWC) kernel on NHWC x on the current stream
    (no sync); returns (N, H // window, W // window, C) in x.dtype (an
    empty output launches nothing).  ``launches`` counts the kernel
    launches this wrapper made."""
    _check(x, window, "avg_pool_blocked")
    n, h, w, c = x.shape
    x = x.contiguous()
    out = torch.empty((n, h // window, w // window, c), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    _launch("pool_nhwc_launch", x.data_ptr(), out.data_ptr(), n, h, w, c,
            int(window), DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    avg_pool_blocked.launches += 1
    return out


def avg_pool_nchw(xc: torch.Tensor, *, window: int = 2) -> torch.Tensor:
    """Launch the naive (NCHW) kernel on NCHW xc on the current stream (no
    sync); returns (N, C, H // window, W // window) in xc.dtype (an empty
    output launches nothing).  ``launches`` counts the kernel launches this
    wrapper made."""
    _check(xc, window, "avg_pool_nchw")
    n, c, h, w = xc.shape
    xc = xc.contiguous()
    out = torch.empty((n, c, h // window, w // window), dtype=xc.dtype,
                      device=xc.device)
    if out.numel() == 0:
        return out
    _launch("pool_nchw_launch", xc.data_ptr(), out.data_ptr(), n * c, h, w,
            int(window), DTYPE_CODES[xc.dtype],
            torch.cuda.current_stream(xc.device).cuda_stream)
    avg_pool_nchw.launches += 1
    return out


avg_pool_blocked.launches = 0
avg_pool_nchw.launches = 0


def naive_walk(x: torch.Tensor, window: int,
               pool_nchw: Callable = avg_pool_nchw) -> torch.Tensor:
    """The reference's naive pooling of NHWC x: crop to whole windows,
    transpose to NCHW (a copy), ``pool_nchw`` (an :func:`avg_pool_nchw`-
    like function), transpose back (a copy)."""
    n, h, w, c = x.shape
    ho, wo = h // window, w // window
    xc = x[:, : ho * window, : wo * window, :].permute(0, 3, 1, 2)
    out = pool_nchw(xc.contiguous(), window=window)
    return out.permute(0, 2, 3, 1).contiguous()


def avg_pool_naive(x: torch.Tensor, *, window: int = 2) -> torch.Tensor:
    """The naive walk of NHWC x through the NCHW kernel; equal to
    :func:`avg_pool_blocked` bit for bit."""
    return naive_walk(x, window)


# the C interface of csrc/avgpool.cu, bound by kernels/build.py
C_SIGNATURES = {
    "pool_nhwc_launch": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p], ctypes.c_int),
    "pool_nchw_launch": ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                         ctypes.c_int),
}
