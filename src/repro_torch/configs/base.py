"""Config registry + generic smoke-reduction.

Every assigned architecture ships as ``configs/<id>.py`` exposing
``config() -> ModelConfig``.  ``smoke(cfg)`` shrinks any config to a
CPU-runnable miniature *of the same family structure* (same block pattern,
same mixer kinds, tiny widths) for the per-arch smoke tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.models.common import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    # populate the registry on demand
    from . import ALL_ARCHS  # noqa: F401  (import side effect)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving miniature for CPU smoke tests."""
    unit = len(cfg.block_pattern)
    n_layers = unit * (2 if unit <= 4 else 1)
    if cfg.moe_first_dense:
        n_layers = max(n_layers, cfg.moe_first_dense + unit)
    d_model = 64
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else n_heads
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_d_ff=64 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_first_dense=min(cfg.moe_first_dense, 1),
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        rope_head_dim=8 if cfg.kv_lora_rank else cfg.rope_head_dim,
        nope_head_dim=16 if cfg.kv_lora_rank else cfg.nope_head_dim,
        v_head_dim=16 if cfg.kv_lora_rank else cfg.v_head_dim,
        n_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        n_audio_frames=16 if cfg.is_encoder_decoder else cfg.n_audio_frames,
        n_image_tokens=16 if cfg.n_image_tokens else 0,
        mamba_d_state=8,
        scan_chunk=8,
        attn_chunk=16,
        max_seq_len=512,
        dtype="float32",
        remat="none",
    )
