"""qwen3-14b [dense] — qk_norm, GQA (hf:Qwen/Qwen3-14B family).

40L d_model=5120 40H (kv=8, head_dim=128) d_ff=17408 vocab=151936.
40 heads do not divide the 16-way ``model`` axis; the sharding legalizer
gives attention the context-parallel (seq_fb) layout automatically.
long_500k skipped (full attention).
"""

from repro_torch.models.common import ModelConfig
from .base import register


@register("qwen3-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
    )
