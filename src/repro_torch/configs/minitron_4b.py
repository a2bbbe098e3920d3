"""minitron-4b [dense] — pruned nemotron (arXiv:2407.14679).

32L d_model=3072 24H (kv=8, head_dim=128) d_ff=9216 vocab=256000.
Nemotron-style squared-ReLU FFN (no GLU).  24 heads don't divide the
16-way model axis -> context-parallel attention via the legalizer.
long_500k skipped (full attention).
"""

from repro_torch.models.common import ModelConfig
from .base import register


@register("minitron-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
        act="relu2",
        rope_theta=1e4,
    )
