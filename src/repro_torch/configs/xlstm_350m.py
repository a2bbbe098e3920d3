"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  ``d_ff=0``: xLSTM stacks
residual mixer blocks only (projection factors live inside the blocks).
Block ratio follows the paper's xLSTM[7:1]-style mixing: one sLSTM per
8-block unit (position 3), the rest mLSTM.  Recurrent state is O(1) in
sequence length, so this arch runs the long_500k cell.
"""

from repro_torch.models.common import BlockDef, ModelConfig
from .base import register

_UNIT = tuple(
    BlockDef("slstm" if i == 3 else "mlstm", "none") for i in range(8)
)


@register("xlstm-350m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        pos_emb="none",
        block_pattern=_UNIT,
        scan_chunk=256,
        subquadratic=True,
        tie_embeddings=True,
    )
