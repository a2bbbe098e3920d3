"""deepseek-v2-236b [moe] — MLA + fine-grained MoE (arXiv:2405.04434).

60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536, nope=128, rope=64,
v=128), MoE 160 routed top-6 + 2 shared experts of d_ff=1536, first layer
dense (d_ff=12288), vocab=102400.  The MLA latent cache is 576 elems/token.
long_500k skipped (MLA is still quadratic attention).
"""

from repro_torch.models.common import BlockDef, ModelConfig
from .base import register


@register("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,                 # dense prologue layer width
        vocab_size=102400,
        rope_theta=1e4,
        q_lora_rank=1536,
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1536,
        moe_first_dense=1,
        block_pattern=(BlockDef("mla", "moe"),),
    )
