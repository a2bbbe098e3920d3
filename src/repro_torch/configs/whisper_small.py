"""whisper-small [audio] — enc-dec, conv frontend stub (arXiv:2212.04356).

12L (enc) + 12L (dec), d_model=768, 12H (kv=12), d_ff=3072, vocab=51865.
The audio conv frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (B, 1500, 768).  Decoder blocks are
self-attn + cross-attn + GELU FFN with LayerNorm and learned positions.
long_500k skipped (full attention, quadratic).
"""

from repro_torch.models.common import BlockDef, ModelConfig
from .base import register


@register("whisper-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        norm="layer",
        act="gelu",
        pos_emb="learned",
        block_pattern=(BlockDef("attn+cross", "dense"),),
        is_encoder_decoder=True,
        n_encoder_layers=12,
        n_audio_frames=1500,
        max_seq_len=32768,
    )
