"""Kernel registry: each op pairs a hand-written CUDA kernel with its
plain PyTorch version, and the tensor's device picks between them.

* a CPU tensor gets the plain version (the CPU tests run it);
* a CUDA tensor gets the kernel, which launches or raises — there is no
  fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

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
