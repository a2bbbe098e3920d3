"""llama-3.2-vision-90b [vlm] — cross-attn image layers
(hf:meta-llama/Llama-3.2-90B-Vision family).

100L d_model=8192 64H (kv=8, head_dim=128) d_ff=28672 vocab=128256.
Every 5th layer is a gated cross-attention layer over image-patch
embeddings (20 cross layers); the vision tower is a STUB — ``input_specs()``
supplies precomputed patch embeddings (B, 1600, 8192).
long_500k skipped (full attention).
"""

from repro_torch.models.common import BlockDef, ModelConfig
from .base import register

_UNIT = (
    BlockDef("cross_attn", "dense"),
    BlockDef("attn", "dense"),
    BlockDef("attn", "dense"),
    BlockDef("attn", "dense"),
    BlockDef("attn", "dense"),
)


@register("llama-3.2-vision-90b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=5e5,
        block_pattern=_UNIT,
        n_image_tokens=1600,
    )
