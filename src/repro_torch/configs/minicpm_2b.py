"""minicpm-2b [dense] — llama-like with WSD schedule (arXiv:2404.06395).

40L d_model=2304 36H (kv=36 = MHA) d_ff=5760 vocab=122753.  MiniCPM's
residual depth-scaling (1.4/sqrt(L)) and tied embeddings are kept; the WSD
(warmup-stable-decay) LR schedule is wired in train/optimizer.py and
selected by this config's ``name`` in the trainer.  vocab 122753 is odd —
the legalizer replicates the embedding rather than failing 16-way vocab TP.
long_500k skipped (full attention).
"""

from repro_torch.models.common import ModelConfig
from .base import register


@register("minicpm-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab_size=122753,
        tie_embeddings=True,
        residual_scale=1.4 / (40 ** 0.5),
        rope_theta=1e4,
    )
