"""qwen3-0.6b [dense] — qk_norm, GQA (hf:Qwen/Qwen3-0.6B family).

28L d_model=1024 16H (kv=8, head_dim=128) d_ff=3072 vocab=151936.
long_500k skipped (full attention).
"""

from repro_torch.models.common import ModelConfig
from .base import register


@register("qwen3-0.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
    )
