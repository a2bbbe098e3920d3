"""Kernel registry: each op pairs a hand-written CUDA kernel with its
plain PyTorch version, and the tensor's device picks between them.

* a CPU tensor gets the plain version (the CPU tests run it), whatever
  the pipeline: the plain version has no pages to stream, as the JAX
  package's jnp reference ignores its pipeline;
* a CUDA tensor gets the kernel, which launches or raises — there is no
  fallback from a CUDA tensor to the plain version.

The four paged-attention ops also take a page-streaming schedule, the
JAX package's ``pipeline`` knob (``kernels/ops.py`` there): ``"off"``
selects their single-walk kernels, ``"double"`` the ring kernels
(``paged_attention_ring`` / ``mla_paged_attention_ring``, bit-identical
to ``"off"``); ``None`` takes the process default
(:func:`set_default_pipeline`, :func:`use_pipeline`).  They forward the
scale pools of a quantized KV pool (``k_scale`` / ``v_scale``, ``c_scale``
/ ``r_scale``) to whichever implementation runs: the single-walk kernels,
the rings or the plain versions.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from . import avgpool as _pool
from . import conv_direct as _conv
from . import conv_winograd as _wino
from . import flash_attention as _flash
from . import gelu as _gelu
from . import inner_product as _ip
from . import layernorm as _ln
from . import paged_attention as _paged
from . import ref as _ref

PIPELINES = ("off", "double")
_default_pipeline = "off"

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_kernel(name: str, *, cuda: Callable, reference: Callable,
                    ring: Optional[Callable] = None) -> None:
    """Register a (CUDA kernel wrapper, plain PyTorch version) pair with
    the same call contract; ``ring`` is the kernel ``pipeline="double"``
    selects on a CUDA tensor (paged-attention ops only, which alone carry
    a ``"ring"`` entry)."""
    _REGISTRY[name] = {"cuda": cuda, "cpu": reference}
    if ring is not None:
        _REGISTRY[name]["ring"] = ring


def registered_kernels() -> Dict[str, Dict[str, Callable]]:
    return dict(_REGISTRY)


def check_pipeline(pipeline: str) -> str:
    """``pipeline`` if it names a schedule in ``PIPELINES``, else raise."""
    if pipeline not in PIPELINES:
        raise ValueError(f"pipeline {pipeline!r} not in {PIPELINES}")
    return pipeline


def set_default_pipeline(pipeline: str) -> None:
    """Process-wide default for ``pipeline=None`` dispatches."""
    global _default_pipeline
    _default_pipeline = check_pipeline(pipeline)


def default_pipeline() -> str:
    return _default_pipeline


@contextlib.contextmanager
def use_pipeline(pipeline: str):
    """Scoped default-pipeline override."""
    prev = _default_pipeline
    set_default_pipeline(pipeline)
    try:
        yield
    finally:
        set_default_pipeline(prev)


def resolve(name: str, device: torch.device,
            pipeline: Optional[str] = None) -> Callable:
    """The implementation of ``name`` for tensors on ``device`` under the
    page-streaming schedule ``pipeline`` (None: the process default).
    ``"double"`` on an op that streams no pages raises."""
    pipeline = check_pipeline(pipeline or _default_pipeline)
    impls = _REGISTRY[name]
    if pipeline != "off" and "ring" not in impls:
        raise ValueError(f"op {name!r} does not support pipeline="
                         f"{pipeline!r} (not a paged streaming kernel)")
    if device.type == "cuda" and pipeline == "double":
        return impls["ring"]
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"op {name!r} has no implementation for "
                         f"device {device}")
    return impls[device.type]


register_kernel("paged_attention", cuda=_paged.paged_attention,
                reference=_paged.paged_attention_reference,
                ring=_paged.paged_attention_ring)


def paged_attention(q, k_pool, v_pool, block_tables, pos, *, scale,
                    soft_cap: float = 0.0, k_scale=None, v_scale=None,
                    pipeline: Optional[str] = None, return_lse: bool = False):
    """GQA paged-decode attention (see kernels/paged_attention.py):
    q (B, KV, G, hd); pools (P, page, KV, hd), quantized with float32
    scale pools (P, page, KV); block_tables (B, n_blocks) int32; pos (B,)
    int32.  Returns (B, KV, G, hd); with ``return_lse`` (the off walk
    only) also the rows' log-sum-exp (B, KV, G) float32."""
    fn = resolve("paged_attention", q.device, pipeline)
    if not return_lse:
        return fn(q, k_pool, v_pool, block_tables, pos, scale=scale,
                  soft_cap=soft_cap, k_scale=k_scale, v_scale=v_scale)
    if fn is _REGISTRY["paged_attention"].get("ring"):
        raise ValueError("return_lse is a decode walk's output; the ring "
                         "(pipeline='double') does not give it")
    return fn(q, k_pool, v_pool, block_tables, pos, scale=scale,
              soft_cap=soft_cap, k_scale=k_scale, v_scale=v_scale,
              return_lse=True)


register_kernel("mla_paged_attention", cuda=_paged.mla_paged_attention,
                reference=_paged.mla_paged_attention_reference,
                ring=_paged.mla_paged_attention_ring)


def mla_paged_attention(q_lat, q_rope, c_pool, r_pool, block_tables, pos, *,
                        scale, c_scale=None, r_scale=None,
                        pipeline: Optional[str] = None):
    """MLA paged decode in the latent space (see
    kernels/paged_attention.py): q_lat (B, H, r); q_rope (B, H, dr); pools
    (P, page, r) / (P, page, dr), quantized with float32 scale pools
    (P, page); block_tables (B, n_blocks) int32; pos (B,) int32.  Returns
    o_lat (B, H, r)."""
    return resolve("mla_paged_attention", q_lat.device, pipeline)(
        q_lat, q_rope, c_pool, r_pool, block_tables, pos, scale=scale,
        c_scale=c_scale, r_scale=r_scale)


register_kernel("paged_attention_verify", cuda=_paged.paged_attention_verify,
                reference=_paged.paged_attention_verify_reference,
                ring=_paged.paged_attention_ring)


def paged_attention_verify(q, k_pool, v_pool, block_tables, pos, *, scale,
                           soft_cap: float = 0.0, k_scale=None, v_scale=None,
                           pipeline: Optional[str] = None):
    """GQA multi-token paged verification (see kernels/paged_attention.py):
    q (B, T, KV, G, hd) at positions pos + t; pools (P, page, KV, hd),
    quantized with float32 scale pools (P, page, KV); block_tables
    (B, n_blocks) int32; pos (B,) int32, the first token's position.
    Returns (B, T, KV, G, hd)."""
    return resolve("paged_attention_verify", q.device, pipeline)(
        q, k_pool, v_pool, block_tables, pos, scale=scale, soft_cap=soft_cap,
        k_scale=k_scale, v_scale=v_scale)


register_kernel("mla_paged_attention_verify",
                cuda=_paged.mla_paged_attention_verify,
                reference=_paged.mla_paged_attention_verify_reference,
                ring=_paged.mla_paged_attention_ring)


def mla_paged_attention_verify(q_lat, q_rope, c_pool, r_pool, block_tables,
                               pos, *, scale, c_scale=None, r_scale=None,
                               pipeline: Optional[str] = None):
    """MLA multi-token paged verification in the latent space (see
    kernels/paged_attention.py): q_lat (B, T, H, r); q_rope (B, T, H, dr);
    pools (P, page, r) / (P, page, dr), quantized with float32 scale pools
    (P, page); block_tables (B, n_blocks) int32; pos (B,) int32, the first
    token's position.  Returns o_lat (B, T, H, r)."""
    return resolve("mla_paged_attention_verify", q_lat.device, pipeline)(
        q_lat, q_rope, c_pool, r_pool, block_tables, pos, scale=scale,
        c_scale=c_scale, r_scale=r_scale)


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


register_kernel("layernorm", cuda=_ln.layernorm,
                reference=_ln.layernorm_reference)


def layernorm(x, scale, bias, eps: float = _ln.EPS):
    """Row LayerNorm over the last axis (two-pass float32 mean and
    variance), scale and bias (D,) read as float32, output in x.dtype."""
    return resolve("layernorm", x.device)(x, scale, bias, eps=eps)


register_kernel("avg_pool_blocked", cuda=_pool.avg_pool_blocked,
                reference=_pool.avg_pool_reference)


def avg_pool(x, window: int = 2):
    """NHWC average pooling, stride = window, blocked walk (channels
    contiguous); H and W cropped to whole windows."""
    return resolve("avg_pool_blocked", x.device)(x, window=window)


register_kernel("avg_pool_naive", cuda=_pool.avg_pool_nchw,
                reference=_pool.avg_pool_nchw_reference)


def avg_pool_naive(x, window: int = 2):
    """NHWC average pooling through the naive walk: transpose to NCHW, the
    NCHW kernel (W innermost), transpose back; equal to :func:`avg_pool`
    bit for bit."""
    return _pool.naive_walk(x, window, resolve("avg_pool_naive", x.device))


def max_pool(x, window: int = 2, stride: int = 2):
    """NHWC max pooling, plain PyTorch on every device, as the JAX
    package routes it to its jnp reference: its work is comparisons, which
    the FLOP count does not see (the paper's section 3.5 caveat)."""
    return _ref.max_pool(x, window, stride)


register_kernel("flash_attention", cuda=_flash.flash_attention,
                reference=_flash.flash_attention_reference)


def flash_attention(q, k, v, causal: bool = True):
    """Flash attention in model layout: q (B, Sq, H, hd), k / v (B, Sk,
    KV, hd); returns (B, Sq, H, hd).  The kernel reads the transposed views
    through their strides (no copies)."""
    o = resolve("flash_attention", q.device)(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal)
    return o.transpose(1, 2)
