"""kimi-k2-1t-a32b [moe] — trillion-param MoE (arXiv:2501.* Kimi K2 report).

61L d_model=7168 64H (GQA kv=8, head_dim=128 — per the assignment table),
MoE 384 routed top-8 + 1 shared expert of d_ff=2048, first layer dense
(d_ff=18432), vocab=163840.  Routed expert params:
61 x 384 x 3 x 7168 x 2048 ~= 1.03e12 — the trillion-parameter cell.
long_500k skipped (full attention).
"""

from repro_torch.models.common import BlockDef, ModelConfig
from .base import register


@register("kimi-k2-1t-a32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=18432,                 # dense prologue layer width
        vocab_size=163840,
        rope_theta=5e4,
        n_experts=384,
        n_shared_experts=1,
        moe_top_k=8,
        moe_d_ff=2048,
        moe_first_dense=1,
        block_pattern=(BlockDef("attn", "moe"),),
    )
