"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 with MoE (arXiv:2403.19887).

32L d_model=4096 32H (kv=8, head_dim=128) d_ff=14336 vocab=65536.
Each 8-layer period has one attention layer (index 3) and seven Mamba
layers; every second layer's FFN is MoE (16 experts, top-2, d_ff=14336).
Mamba state is O(1) in sequence length and only 4 attention layers carry a
KV cache (seq-sharded by the legalizer), so this arch runs long_500k.
"""

from repro_torch.models.common import BlockDef, ModelConfig
from .base import register

_UNIT = tuple(
    BlockDef("attn" if i == 3 else "mamba",
             "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        rope_theta=1e4,
        pos_emb="none",            # jamba uses no positional encoding
        n_experts=16,
        moe_top_k=2,
        moe_d_ff=14336,
        block_pattern=_UNIT,
        mamba_d_state=16,
        scan_chunk=256,
        subquadratic=True,
    )
