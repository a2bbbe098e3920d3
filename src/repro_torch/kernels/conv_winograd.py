"""Winograd F(2x2, 3x3) convolution: the elementwise stage's CUDA kernel
wrapper, its plain version, and the whole convolution around it.

The paper's Winograd observation: the fastest convolution, yet the lowest
utilization, because it does 2.25x less multiply work (16 instead of 36
products per 2x2 output patch and input channel) and spends its time in
the transforms.  As in the reference, the input and output transforms are
plain float32 tensor code (``kernels/ref.py``), and the stage that holds
the whole multiply reduction — 16 independent (T, Cin) @ (Cin, Cout)
products, float32 in and out — is :func:`winograd_elementwise_stage`,
which launches ``csrc/winograd_stage.cu`` (the port of the Pallas
``winograd_elementwise_stage``) on the float32 GEMM core; :func:`plan`
says which producers fill its stages.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from . import build
from . import ref as _ref
from .inner_product import describe_plan


def winograd_elementwise_stage_reference(v: torch.Tensor, u: torch.Tensor
                                         ) -> torch.Tensor:
    """Plain version: (16, T, Cin) @ (16, Cin, Cout) -> float32
    (16, T, Cout)."""
    return _ref.winograd_stage(v, u)


def winograd_elementwise_stage(v: torch.Tensor, u: torch.Tensor
                               ) -> torch.Tensor:
    """Launch the CUDA stage kernel on the current stream (no sync).  v
    (P, T, Cin) and u (P, Cin, Cout): contiguous float32 CUDA tensors;
    returns float32 (P, T, Cout).  ``launches`` counts the kernel launches
    this wrapper made."""
    if not v.is_cuda:
        raise ValueError(
            "winograd_elementwise_stage launches a CUDA kernel and takes "
            f"CUDA tensors only (v is on {v.device}); kernels.ops dispatches "
            "CPU tensors to winograd_elementwise_stage_reference")
    for name, t in (("v", v), ("u", u)):
        if (t.dim() != 3 or t.dtype != torch.float32 or t.device != v.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want a contiguous 3-D float32 tensor "
                             f"on {v.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    p, t_, cin = v.shape
    p2, cin2, cout = u.shape
    if p2 != p or cin2 != cin or min(p, t_, cin, cout) < 1:
        raise ValueError(f"v {tuple(v.shape)} and u {tuple(u.shape)} do not "
                         "match")
    m = torch.empty((p, t_, cout), dtype=torch.float32, device=v.device)
    lib = build.library("winograd_stage", C_SIGNATURES)
    err = lib.winograd_stage_launch(
        v.data_ptr(), u.data_ptr(), m.data_ptr(), p, t_, cin, cout,
        torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"winograd_elementwise_stage kernel launch "
                           f"failed: CUDA error {err}")
    winograd_elementwise_stage.launches += 1
    return m


winograd_elementwise_stage.launches = 0


def plan(v: torch.Tensor, u: torch.Tensor) -> str:
    """The stage producers :func:`winograd_elementwise_stage` takes for
    these CUDA tensors (the C launch function's own choice from shape and
    alignment; nothing is launched), in :func:`describe_plan`'s words."""
    if not v.is_cuda:
        raise ValueError("plan asks the CUDA library and takes CUDA tensors "
                         f"only (v is on {v.device})")
    lib = build.library("winograd_stage", C_SIGNATURES)
    p, t_, cin = v.shape
    return describe_plan(lib.winograd_stage_plan(
        v.data_ptr(), u.data_ptr(), p, t_, cin, u.shape[-1]))


# the C interface of csrc/winograd_stage.cu, bound by kernels/build.py
C_SIGNATURES = {
    "winograd_stage_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int),
    "winograd_stage_plan": (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4, ctypes.c_int),
}


def conv2d_winograd(x: torch.Tensor, w: torch.Tensor, *,
                    stage: Callable = winograd_elementwise_stage
                    ) -> torch.Tensor:
    """Winograd conv, stride 1, SAME, x (N, H, W, Cin), w (3, 3, Cin,
    Cout): float32 transforms around ``stage`` (the CUDA kernel unless
    another implementation is passed); output in x.dtype."""
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"F(2x2, 3x3) takes 3x3 kernels, not "
                         f"{tuple(w.shape[:2])}")
    n, h, wd, cin = x.shape
    v, nh, nw = _ref.winograd_input_transform(x)
    u = _ref.winograd_kernel_transform(w).reshape(16, cin, -1).contiguous()
    m = stage(v, u)
    return _ref.winograd_output_transform(m, n, nh, nw, h, wd).to(x.dtype)
