"""Kernel registry: each op pairs a hand-written CUDA kernel with its
plain PyTorch version, and the tensor's device picks between them.

* a CPU tensor gets the plain version (the CPU tests run it);
* a CUDA tensor gets the kernel, which launches or raises — there is no
  fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from . import conv_direct as _conv
from . import conv_winograd as _wino
from . import gelu as _gelu
from . import inner_product as _ip
from . import paged_attention as _paged

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_kernel(name: str, *, cuda: Callable, reference: Callable
                    ) -> None:
    """Register a (CUDA kernel wrapper, plain PyTorch version) pair with
    the same call contract."""
    _REGISTRY[name] = {"cuda": cuda, "cpu": reference}


def registered_kernels() -> Dict[str, Dict[str, Callable]]:
    return dict(_REGISTRY)


def resolve(name: str, device: torch.device) -> Callable:
    """The implementation of ``name`` for tensors on ``device``."""
    impls = _REGISTRY[name]
    if device.type not in impls:
        raise ValueError(f"op {name!r} has no implementation for "
                         f"device {device}")
    return impls[device.type]


register_kernel("paged_attention", cuda=_paged.paged_attention,
                reference=_paged.paged_attention_reference)


def paged_attention(q, k_pool, v_pool, block_tables, pos, *, scale,
                    soft_cap: float = 0.0):
    """GQA paged-decode attention (see kernels/paged_attention.py):
    q (B, KV, G, hd); pools (P, page, KV, hd); block_tables (B, n_blocks)
    int32; pos (B,) int32.  Returns (B, KV, G, hd)."""
    return resolve("paged_attention", q.device)(
        q, k_pool, v_pool, block_tables, pos, scale=scale, soft_cap=soft_cap)


register_kernel("mla_paged_attention", cuda=_paged.mla_paged_attention,
                reference=_paged.mla_paged_attention_reference)


def mla_paged_attention(q_lat, q_rope, c_pool, r_pool, block_tables, pos, *,
                        scale):
    """MLA paged decode in the latent space (see
    kernels/paged_attention.py): q_lat (B, H, r); q_rope (B, H, dr); pools
    (P, page, r) / (P, page, dr); block_tables (B, n_blocks) int32; pos
    (B,) int32.  Returns o_lat (B, H, r)."""
    return resolve("mla_paged_attention", q_lat.device)(
        q_lat, q_rope, c_pool, r_pool, block_tables, pos, scale=scale)


register_kernel("paged_attention_verify", cuda=_paged.paged_attention_verify,
                reference=_paged.paged_attention_verify_reference)


def paged_attention_verify(q, k_pool, v_pool, block_tables, pos, *, scale,
                           soft_cap: float = 0.0):
    """GQA multi-token paged verification (see kernels/paged_attention.py):
    q (B, T, KV, G, hd) at positions pos + t; pools (P, page, KV, hd);
    block_tables (B, n_blocks) int32; pos (B,) int32, the first token's
    position.  Returns (B, T, KV, G, hd)."""
    return resolve("paged_attention_verify", q.device)(
        q, k_pool, v_pool, block_tables, pos, scale=scale, soft_cap=soft_cap)


register_kernel("mla_paged_attention_verify",
                cuda=_paged.mla_paged_attention_verify,
                reference=_paged.mla_paged_attention_verify_reference)


def mla_paged_attention_verify(q_lat, q_rope, c_pool, r_pool, block_tables,
                               pos, *, scale):
    """MLA multi-token paged verification in the latent space (see
    kernels/paged_attention.py): q_lat (B, T, H, r); q_rope (B, T, H, dr);
    pools (P, page, r) / (P, page, dr); block_tables (B, n_blocks) int32;
    pos (B,) int32, the first token's position.  Returns o_lat
    (B, T, H, r)."""
    return resolve("mla_paged_attention_verify", q_lat.device)(
        q_lat, q_rope, c_pool, r_pool, block_tables, pos, scale=scale)


# the paper's primitives (launch/primitives.py times them)

register_kernel("inner_product", cuda=_ip.inner_product,
                reference=_ip.inner_product_reference)


def inner_product(x, w, fuse: str = "none"):
    """(M, K) @ (K, N), float32 sum, epilogue ``none``/``relu``/``gelu``,
    output in x.dtype (see kernels/inner_product.py)."""
    return resolve("inner_product", x.device)(x, w, fuse=fuse)


register_kernel("gelu_2d", cuda=_gelu.gelu_2d,
                reference=_gelu.gelu_2d_reference)


def gelu(x):
    """tanh-GELU of any shape, blocked (coalesced) walk."""
    return _gelu.gelu_layout(x, _gelu.blocked_tile,
                             resolve("gelu_2d", x.device))


def gelu_naive(x):
    """tanh-GELU of any shape, naive (strided) walk; equal to
    :func:`gelu` bit for bit."""
    return _gelu.gelu_layout(x, _gelu.naive_tile,
                             resolve("gelu_2d", x.device))


register_kernel("conv2d_direct", cuda=_conv.conv2d_direct,
                reference=_conv.conv2d_direct_reference)


def conv2d(x, w):
    """Direct convolution, NHWC x HWIO, stride 1, SAME (see
    kernels/conv_direct.py for the padding split)."""
    return resolve("conv2d_direct", x.device)(x, w)


register_kernel("winograd_elementwise_stage",
                cuda=_wino.winograd_elementwise_stage,
                reference=_wino.winograd_elementwise_stage_reference)


def winograd_elementwise_stage(v, u):
    """(16, T, Cin) @ (16, Cin, Cout) -> float32 (16, T, Cout)."""
    return resolve("winograd_elementwise_stage", v.device)(v, u)


def conv2d_winograd(x, w):
    """Winograd F(2x2, 3x3) convolution, stride 1, SAME: float32
    transforms around the elementwise stage; output in x.dtype."""
    return _wino.conv2d_winograd(
        x, w, stage=resolve("winograd_elementwise_stage", x.device))
